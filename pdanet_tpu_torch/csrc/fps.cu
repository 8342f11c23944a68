// Distance farthest-point sampling (D-FPS) for Hopper (sm_90a).
//
// Replaces the TPU kernels pdanet_tpu/ops/pallas/fps.py:
//   farthest_point_sample_pallas (:365) -> _fps_kernel (:63), _fps_kernel_v2 (:126)
//   farthest_point_sample_pallas_grouped (:317) -> _fps_kernel_grouped (:173)
// One CTA per frame covers both: frames run on separate SMs, so the TPU's
// frame grouping (latency hiding inside one program) has no counterpart.
//
// Semantics (held exactly against _farthest_point_sample_xla,
// pdanet_tpu/ops/sampling.py:62-83): the first index is 0, the running
// min-distance starts at 1e10, each step takes the argmax with the lowest
// index on ties.  The distance is dx*dx + dy*dy + dz*dz evaluated left to
// right with round-to-nearest intrinsics, so no FMA contraction can change
// a tie and with it an index.
//
// What bounds it on the H100: the npoint-step dependency chain.  Each step
// is ~N/1024 distance updates per thread plus one block-wide argmax (two
// __syncthreads), so the kernel is latency bound, not bandwidth bound; one
// SM works per frame and the rest of the card idles at B = 1.
// Design: the frame's xyz lives in shared memory (12 B/point: 192 KB at
// 16384 points, opt-in dynamic smem) and the running min-distance in
// registers (PPT points per thread, template); clouds too large for shared
// memory read xyz from global (L2-resident), and clouds above 32768 points
// keep the min-distance in a global scratch row.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// PPT > 0: PPT min-distances per thread in registers (N <= PPT * 1024).
// PPT == 0: min-distances in the global scratch row temp_g (any N).
template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz_soa, int N, int npoint, int use_smem,
           float* __restrict__ temp_g, int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int cur;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* g = xyz_soa + (size_t)b * 3 * N;
  const float* xs = g;
  const float* ys = g + N;
  const float* zs = g + 2 * N;
  if (use_smem) {
    for (int i = tid; i < 3 * N; i += kThreads) smem[i] = g[i];
    xs = smem;
    ys = smem + N;
    zs = smem + 2 * N;
  }
  float* temp = temp_g + (size_t)b * N;
  float dist[PPT > 0 ? PPT : 1];
  if constexpr (PPT > 0) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) dist[k] = 1e10f;
  } else {
    for (int i = tid; i < N; i += kThreads) temp[i] = 1e10f;
  }
  int32_t* o = out + (size_t)b * npoint;
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int old = 0;
  for (int j = 1; j < npoint; ++j) {
    const float cx = xs[old], cy = ys[old], cz = zs[old];
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
    if constexpr (PPT > 0) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int i = tid + k * kThreads;  // ascending within the thread
        if (i < N) {
          const float dx = __fsub_rn(xs[i], cx);
          const float dy = __fsub_rn(ys[i], cy);
          const float dz = __fsub_rn(zs[i], cz);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
          const float t = fminf(dist[k], d);
          dist[k] = t;
          if (t > bv) {
            bv = t;
            bi = i;
          }
        }
      }
    } else {
      for (int i = tid; i < N; i += kThreads) {
        const float dx = __fsub_rn(xs[i], cx);
        const float dy = __fsub_rn(ys[i], cy);
        const float dz = __fsub_rn(zs[i], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const float t = fminf(temp[i], d);
        temp[i] = t;
        if (t > bv) {
          bv = t;
          bi = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        better(bv, bi, ov, oi);
      }
      if (lane == 0) {
        cur = bi;
        o[j] = bi;
      }
    }
    __syncthreads();
    old = cur;
  }
}

template <int PPT>
cudaError_t launch(const float* xyz_soa, int B, int N, int npoint, float* temp,
                   int32_t* out, cudaStream_t stream) {
  const size_t smem_bytes = (size_t)3 * N * sizeof(float);
  // 227 KB is the H100's per-block limit; keep 1 KB for the static arrays
  const int use_smem = smem_bytes + 1024 <= 232448 ? 1 : 0;
  const size_t dyn = use_smem ? smem_bytes : 0;
  if (dyn > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return e;
  }
  fps_kernel<PPT><<<B, kThreads, dyn, stream>>>(xyz_soa, N, npoint, use_smem, temp, out);
  return cudaGetLastError();
}

}  // namespace

// xyz_soa: (B, 3, N) float32 contiguous; out: (B, npoint) int32;
// temp: (B, N) float32 scratch, read only when N > 32768 (may be null otherwise).
extern "C" int pdanet_fps(const float* xyz_soa, int B, int N, int npoint, float* temp,
                          int32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ppt = (N + kThreads - 1) / kThreads;
  if (ppt <= 1) return (int)launch<1>(xyz_soa, B, N, npoint, temp, out, s);
  if (ppt <= 2) return (int)launch<2>(xyz_soa, B, N, npoint, temp, out, s);
  if (ppt <= 4) return (int)launch<4>(xyz_soa, B, N, npoint, temp, out, s);
  if (ppt <= 8) return (int)launch<8>(xyz_soa, B, N, npoint, temp, out, s);
  if (ppt <= 16) return (int)launch<16>(xyz_soa, B, N, npoint, temp, out, s);
  if (ppt <= 32) return (int)launch<32>(xyz_soa, B, N, npoint, temp, out, s);
  return (int)launch<0>(xyz_soa, B, N, npoint, temp, out, s);
}
