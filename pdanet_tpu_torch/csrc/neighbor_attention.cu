// Per-centre neighbour attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel pdanet_tpu/ops/pallas/attention.py:
//   neighbor_attention_flat (:201) -> _attn_kernel (:58)
//
// Semantics: q2, k2, v2 and o are the flat (R, H*hd) layout of the PDA
// transformer, R = centres * K, the K rows of one centre contiguous.  Per
// centre and head: o = softmax(q k^T / sqrt(hd)) v over the centre's K
// tokens, no mask.  q is scaled before the product (as the TPU kernel
// does); scores, softmax and the P.V sums are float32 for float32 and
// bfloat16 inputs alike, and o is written in the input type.
//
// What bounds it on the H100: it moves 4 * R * H * hd elements and does
// 4 * K * hd flops per element pair, about K/2 flops per byte in f32 --
// memory bound at the shipped K = 16/32.  The TPU kernel's 128-row
// block-diagonal masking (wasting 128/K of its MXU work) has no purpose here.
// Design: one block per (centre, head) stages the K x hd tiles of q, k and
// v in shared memory as float32 (rows padded to hd + 1 to spread banks),
// computes the K x K scores, takes the row softmax one warp per row, and
// writes o.  Any K <= 64 and hd <= 128 run; there is no shape gate.
// Tensor cores (wgmma) and multi-centre blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int K, int H, int hd, float scale) {
  extern __shared__ float sm[];
  const int ld = hd + 1;
  float* qs = sm;
  float* ks = qs + K * ld;
  float* vs = ks + K * ld;
  float* ps = vs + K * ld;  // K x (K + 1)
  const int c = blockIdx.x / H;
  const int h = blockIdx.x - c * H;
  const int D = H * hd;
  const size_t row0 = (size_t)c * K;
  const int col0 = h * hd;
  const int tid = threadIdx.x;

  for (int e = tid; e < K * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    const size_t gi = (row0 + r) * D + col0 + d;
    qs[r * ld + d] = __fmul_rn(to_f(q[gi]), scale);
    ks[r * ld + d] = to_f(k[gi]);
    vs[r * ld + d] = to_f(v[gi]);
  }
  __syncthreads();

  for (int e = tid; e < K * K; e += kThreads) {
    const int i = e / K;
    const int j = e - i * K;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = __fmaf_rn(qs[i * ld + d], ks[j * ld + d], s);
    ps[i * (K + 1) + j] = s;
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int i = tid >> 5; i < K; i += kThreads / 32) {
    float* row = ps + i * (K + 1);
    float m = -CUDART_INF_F;
    for (int j = lane; j < K; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int j = lane; j < K; j += 32) {
      const float ex = expf(row[j] - m);
      row[j] = ex;
      sum += ex;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < K; j += 32) row[j] = __fdiv_rn(row[j], sum);
  }
  __syncthreads();

  for (int e = tid; e < K * hd; e += kThreads) {
    const int i = e / hd;
    const int d = e - i * hd;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) acc = __fmaf_rn(ps[i * (K + 1) + j], vs[j * ld + d], acc);
    o[(row0 + i) * D + col0 + d] = from_f<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int R, int K, int H,
                   int hd, cudaStream_t stream) {
  const size_t smem = ((size_t)3 * K * (hd + 1) + (size_t)K * (K + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (R / K) * H;
  if (blocks == 0) return cudaSuccess;
  attn_kernel<T><<<blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, K, H, hd, (float)(1.0 / sqrt((double)hd)));
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (R, H*hd) contiguous, R a multiple of K; is_bf16 selects
// bfloat16 elements, otherwise float32.
extern "C" int pdanet_neighbor_attention(const void* q, const void* k, const void* v, void* o,
                                         int R, int K, int H, int hd, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return (int)launch<__nv_bfloat16>(q, k, v, o, R, K, H, hd, s);
  return (int)launch<float>(q, k, v, o, R, K, H, hd, s);
}
