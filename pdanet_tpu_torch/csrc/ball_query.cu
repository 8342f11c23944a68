// Multi-radius first-K ball query for Hopper (sm_90a).
//
// Replaces the TPU kernels pdanet_tpu/ops/pallas/ball_query.py:
//   ball_query_multi_pallas_streamed (:306) -> _bq_stream_kernel (:232), N > 8192
//   ball_query_multi_pallas (:407) -> _bq_kernel (:174), N <= 8192
// The TPU needed two kernels only because of VMEM; one kernel covers both.
//
// Semantics (held exactly against _ball_query_multi_xla,
// pdanet_tpu/ops/ball_query.py:164-188): for each centre and each radius,
// the first K support indices in scan order with d2 < r2 (strict), where
// d2 = dx*dx + dy*dy + dz*dz is evaluated left to right without FMA
// contraction and r2 = float32(radius * radius) is computed on the host.
// Unfilled slots repeat the first hit; a centre with no hit gets 0.  The
// result never depends on the order of the cloud (the x-sort of the
// pipeline only makes the scan stop earlier).
//
// What bounds it on the H100: the support scan, N distance evaluations per
// centre in the worst case (a ball that never fills), read from L2.
// Design: one warp per centre scans the support 32 points at a time; a
// __ballot_sync + __popc per radius places the hits in scan order with one
// counter per radius, and the warp stops as soon as every radius is full.
// All radii share one distance evaluation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRadii = 4;
constexpr int kWarpsPerBlock = 8;

struct BallQueryArgs {
  int n_radii;
  float r2[kMaxRadii];
  int k[kMaxRadii];
  int32_t* out[kMaxRadii];
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centres,
                  int B, int N, int M, BallQueryArgs a) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (gw >= (long long)B * M) return;  // whole warp leaves together
  const int b = (int)(gw / M);
  const float cx = centres[gw * 3 + 0];
  const float cy = centres[gw * 3 + 1];
  const float cz = centres[gw * 3 + 2];
  const float* p = xyz + (size_t)b * N * 3;
  const unsigned lt_mask = (1u << lane) - 1u;

  int cnt[kMaxRadii];
  int first[kMaxRadii];
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    cnt[r] = 0;
    first[r] = 0;
  }
  for (int base = 0; base < N; base += 32) {
    const int i = base + lane;
    float d2 = 0.f;
    const bool in = i < N;
    if (in) {
      const float dx = __fsub_rn(cx, p[i * 3 + 0]);
      const float dy = __fsub_rn(cy, p[i * 3 + 1]);
      const float dz = __fsub_rn(cz, p[i * 3 + 2]);
      d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    }
    bool all_full = true;
#pragma unroll
    for (int r = 0; r < kMaxRadii; ++r) {
      if (r < a.n_radii) {
        const unsigned hits = __ballot_sync(0xffffffffu, in && d2 < a.r2[r]);
        if (cnt[r] < a.k[r] && hits) {
          if (cnt[r] == 0) first[r] = base + __ffs((int)hits) - 1;
          const int pos = cnt[r] + __popc(hits & lt_mask);
          if (((hits >> lane) & 1u) && pos < a.k[r]) a.out[r][gw * a.k[r] + pos] = i;
          cnt[r] += __popc(hits);
        }
        all_full = all_full && cnt[r] >= a.k[r];
      }
    }
    if (all_full) break;  // counters are warp-uniform
  }
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    if (r < a.n_radii) {
      const int filled = cnt[r] < a.k[r] ? cnt[r] : a.k[r];
      for (int s = filled + lane; s < a.k[r]; s += 32) a.out[r][gw * a.k[r] + s] = first[r];
    }
  }
}

}  // namespace

// xyz: (B, N, 3) float32; centres: (B, M, 3) float32; r2, k: n_radii host
// values; outs: n_radii device pointers to (B, M, k[r]) int32.
extern "C" int pdanet_ball_query(const float* xyz, const float* centres, int B, int N, int M,
                                 int n_radii, const float* r2, const int* k, void* const* outs,
                                 void* stream) {
  if (n_radii < 1 || n_radii > kMaxRadii) return (int)cudaErrorInvalidValue;
  BallQueryArgs a;
  a.n_radii = n_radii;
  for (int r = 0; r < kMaxRadii; ++r) {
    a.r2[r] = r < n_radii ? r2[r] : 0.f;
    a.k[r] = r < n_radii ? k[r] : 0;
    a.out[r] = r < n_radii ? (int32_t*)outs[r] : nullptr;
  }
  const long long warps = (long long)B * M;
  const int blocks = (int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (blocks == 0) return 0;
  ball_query_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(xyz, centres, B,
                                                                             N, M, a);
  return (int)cudaGetLastError();
}
