// Per-centre neighbour attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel pdanet_tpu/ops/pallas/attention.py:
//   neighbor_attention_flat (:201) -> _attn_kernel (:58)
//
// This SIMT kernel takes float32 and float64; bfloat16 runs on the tensor
// cores in neighbor_attention_mma.cu.  float32 stays here because tensor
// cores in float32 mean TF32, and the float32 serving frame is held index
// for index against the CPU; float64 is for the exact train-step check.
//
// Semantics: q2, k2, v2 and o are the flat (R, H*hd) layout of the PDA
// transformer, R = centres * K, the K rows of one centre contiguous.  Per
// centre and head: o = softmax(q k^T / sqrt(hd)) v over the centre's K
// tokens, no mask.  q is scaled before the product (as the TPU kernel
// does); scores, softmax and the P.V sums are in the input type, each
// score's and each output's FMA chain in d and j order.
//
// What bounds it on the H100: bytes.  It moves 4 * R * H * hd elements
// and does 2 K multiply-adds per element of one tensor: 4 * 32768 * 256 *
// 4 bytes = 134 MB at SA1 b1 K 32 in float32, 0.040 ms at 3.35 TB/s,
// against 0.016 ms of float32 FMAs.  The TPU kernel's 128-row
// block-diagonal masking (wasting 128/K of its MXU work) has no purpose
// here.
//
// Design.  An inner loop that reads both operands of every FMA from
// shared memory is bound by shared-memory wavefronts, not by HBM.  So the
// operand that differs per lane stays in registers and the operand that
// all lanes of a warp share is a broadcast 16-byte load feeding W FMAs in
// each lane.  And since a unit's tiles take 26 KB (K 32, hd 64), the four
// warps of a CTA share one unit, so that enough warps stay resident to
// hide the latency of those loads and of the FMA chains:
// - One CTA of kWarps = 4 warps per group of units (centre, head): one
//   unit, or two at K <= 16 (one per half-warp).  16-byte cp.async copies
//   (one element each where hd or a pointer does not allow it) bring the
//   group's q, k and v tiles into shared memory (attention_common.cuh:
//   tiles, padding, plan).
// - Scores: lane i owns query row i (and i + 32 at K > 32); warp w takes
//   the score columns j = w, w + 4, ...  The lane holds DC columns of its
//   scaled q row in registers and reads k[j] as broadcast 16-byte loads.
// - Softmax: the row's max and sum over the four warps' partials in a
//   small shared array; P into a K x (K + 1) tile.
// - P v: warp w takes the 16-byte column chunks w, w + 4, ... of o; per
//   chunk acc += P[i][j] v[j] over j, P[i][j] at lane-distinct addresses
//   and v[j] broadcast.  The lane writes its o chunks over its q row; the
//   CTA then writes the tile with coalesced 16-byte stores.
// Any K <= 64 and hd <= 128 run, in float32 and in float64 (shared memory
// allows every such shape); the kernel is templated on KMAX = K rounded up
// to 16, 32 or 64, so that the scores stay in registers.

#include <cmath>

#include "attention_common.cuh"

namespace {

using namespace pdanet_attn;

// Elements of a CTA's shared memory: per unit the q, k and v tiles and the
// K x (K + 1) P tile (rounded up to W), then the kWarps x (UPC K) partials.
template <typename C, int KMAX>
__host__ __device__ __forceinline__ size_t unit_elems(int K, int ld) {
  constexpr int W = Vec<C>::W;
  return (size_t)3 * K * ld + (K * (K + 1) + W - 1) / W * W;
}
template <typename C, int KMAX>
__host__ __device__ __forceinline__ size_t cta_elems(int K, int ld) {
  return Split<KMAX>::UPC * (unit_elems<C, KMAX>(K, ld) + (size_t)kWarps * K);
}

// sc[t] = (s q[i]) . k[j] for this warp's columns j = w + kWarps t < K.
template <typename C, int JPT>
__device__ __forceinline__ void scores_row(C (&sc)[JPT], const C* qrow, const C* ks, int w,
                                           int K, int hdp, int ld, C scale) {
  constexpr int W = Vec<C>::W, DC = Vec<C>::DC;
#pragma unroll
  for (int t = 0; t < JPT; ++t) sc[t] = 0;
  for (int d0 = 0; d0 < hdp; d0 += DC) {
    C qr[DC];
#pragma unroll
    for (int c = 0; c < DC; c += W)
      if (d0 + c < hdp) {
        ld16(qr + c, qrow + d0 + c);
#pragma unroll
        for (int e = 0; e < W; ++e) qr[c + e] = mul_rn(qr[c + e], scale);
      }
#pragma unroll
    for (int t = 0; t < JPT; ++t) {
      const int j = w + kWarps * t;
      if (j < K) {
#pragma unroll
        for (int c = 0; c < DC; c += W)
          if (d0 + c < hdp) {
            C kv[W];
            ld16(kv, ks + j * ld + d0 + c);
#pragma unroll
            for (int e = 0; e < W; ++e) sc[t] = fma_rn(qr[c + e], kv[e], sc[t]);
          }
      }
    }
  }
}

template <typename C, int KMAX>
__global__ void __launch_bounds__(32 * kWarps)
attn_kernel(const C* __restrict__ q, const C* __restrict__ k, const C* __restrict__ v,
            C* __restrict__ o, int K, int H, int hd, int ld, int units, int vec, C scale) {
  using S = Split<KMAX>;
  constexpr int W = Vec<C>::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int tile = K * ld;
  const size_t ue = unit_elems<C, KMAX>(K, ld);
  C* red = sm + S::UPC * ue;  // kWarps x (UPC K) partials of the row max and sum
  const int rows = S::UPC * K;
  const int hdp = (hd + W - 1) / W * W;
  const int g = blockIdx.x;
#pragma unroll
  for (int uu = 0; uu < S::UPC; ++uu) {
    const int unit = g * S::UPC + uu;
    if (unit < units) {
      C* base = sm + uu * ue;
      load_tile(base, q, unit, K, H, hd, ld, vec, tid);
      load_tile(base + tile, k, unit, K, H, hd, ld, vec, tid);
      load_tile(base + 2 * tile, v, unit, K, H, hd, ld, vec, tid);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int u = S::UPC == 2 ? lane >> 4 : 0;     // this lane's unit in the group
  const int r0 = S::UPC == 2 ? lane & 15 : lane;  // and its first row
  const bool mine = g * S::UPC + u < units;
  C* qs = sm + u * ue;
  const C* ks = qs + tile;
  const C* vs = ks + tile;
  C* ps = qs + 3 * tile;

  C sc[S::RPL][S::JPT];
  C m[S::RPL];
#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) {
      scores_row<C, S::JPT>(sc[rr], qs + i * ld, ks, w, K, hdp, ld, scale);
      C mx = static_cast<C>(-CUDART_INF);
#pragma unroll
      for (int t = 0; t < S::JPT; ++t)
        if (w + kWarps * t < K) mx = max_c(mx, sc[rr][t]);
      red[w * rows + u * K + i] = mx;
    }
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) {
      m[rr] = red[u * K + i];
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww) m[rr] = max_c(m[rr], red[ww * rows + u * K + i]);
    }
  }
  __syncthreads();  // every max read: the partials' space takes the sums
#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) {
      C sum = 0;
#pragma unroll
      for (int t = 0; t < S::JPT; ++t)
        if (w + kWarps * t < K) {
          sc[rr][t] = exp_c(sub_rn(sc[rr][t], m[rr]));
          sum = add_rn(sum, sc[rr][t]);
        }
      red[w * rows + u * K + i] = sum;
    }
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) {
      C sum = red[u * K + i];
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww) sum = add_rn(sum, red[ww * rows + u * K + i]);
#pragma unroll
      for (int t = 0; t < S::JPT; ++t) {
        const int j = w + kWarps * t;
        if (j < K) ps[i * (K + 1) + j] = div_rn(sc[rr][t], sum);
      }
    }
  }
  __syncthreads();  // P complete; every q row read

#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) row_times_tile(qs, ps, vs, i, w, K, hdp, ld, false, scale);
  }
  __syncthreads();
#pragma unroll
  for (int uu = 0; uu < S::UPC; ++uu)
    if (g * S::UPC + uu < units)
      store_tile(o, sm + uu * ue, g * S::UPC + uu, K, H, hd, ld, vec, tid);
}

template <typename C, int KMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int R, int K, int H,
                   int hd, cudaStream_t stream) {
  constexpr int UPC = Split<KMAX>::UPC;
  const int units = (R / K) * H;
  if (units == 0) return cudaSuccess;
  Plan p;
  cudaError_t e = make_plan(attn_kernel<C, KMAX>, hd, Vec<C>::W, sizeof(C),
                            [&](int ld) { return cta_elems<C, KMAX>(K, ld); }, &p);
  if (e != cudaSuccess) return e;
  const void* ptrs[4] = {q, k, v, o};
  attn_kernel<C, KMAX><<<(units + UPC - 1) / UPC, 32 * kWarps, p.smem, stream>>>(
      (const C*)q, (const C*)k, (const C*)v, (C*)o, K, H, hd, p.ld, units,
      vec_ok(hd, Vec<C>::W, ptrs, 4), (C)(1.0 / sqrt((double)hd)));
  return cudaGetLastError();
}

template <typename C>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int R, int K, int H,
                     int hd, cudaStream_t s) {
  if (K < 1 || K > 64 || hd < 1 || hd > 128) return cudaErrorInvalidValue;
  if (K <= 16) return launch<C, 16>(q, k, v, o, R, K, H, hd, s);
  if (K <= 32) return launch<C, 32>(q, k, v, o, R, K, H, hd, s);
  return launch<C, 64>(q, k, v, o, R, K, H, hd, s);
}

}  // namespace

// q, k, v, o: (R, H*hd) contiguous, R a multiple of K, K <= 64, hd <= 128;
// dtype is a DType code (attention_common.cuh): float32 or float64.
extern "C" int pdanet_neighbor_attention(const void* q, const void* k, const void* v, void* o,
                                         int R, int K, int H, int hd, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kFloat32: return (int)dispatch<float>(q, k, v, o, R, K, H, hd, s);
    case kFloat64: return (int)dispatch<double>(q, k, v, o, R, K, H, hd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
