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
// bfloat16 inputs alike (float64 for float64 inputs, which exact checks
// use), and o is written in the input type.
//
// What bounds it on the H100: it moves 4 * R * H * hd elements and does
// 4 * K * hd flops per element pair, about K/2 flops per byte in f32 --
// memory bound at the shipped K = 16/32.  The TPU kernel's 128-row
// block-diagonal masking (wasting 128/K of its MXU work) has no purpose here.
// Design: one block per (centre, head) stages the K x hd tiles of q, k and
// v in shared memory in the sum type (rows padded to hd + 1 to spread banks),
// computes the K x K scores, takes the row softmax one warp per row, and
// writes o.  Any K <= 64 and hd <= 128 run; there is no shape gate.
// Tensor cores (wgmma) and multi-centre blocks are later work.

#include "attention_common.cuh"

namespace {

using namespace pdanet_attn;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int K, int H, int hd, double scale_d) {
  using C = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);
  const C scale = static_cast<C>(scale_d);
  const int ld = hd + 1;
  C* qs = sm;
  C* ks = qs + K * ld;
  C* vs = ks + K * ld;
  C* ps = vs + K * ld;  // K x (K + 1)
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
    qs[r * ld + d] = mul_rn(load_c(q[gi]), scale);
    ks[r * ld + d] = load_c(k[gi]);
    vs[r * ld + d] = load_c(v[gi]);
  }
  __syncthreads();

  for (int e = tid; e < K * K; e += kThreads) {
    const int i = e / K;
    const int j = e - i * K;
    C s = 0;
    for (int d = 0; d < hd; ++d) s = fma_rn(qs[i * ld + d], ks[j * ld + d], s);
    ps[i * (K + 1) + j] = s;
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int i = tid >> 5; i < K; i += kThreads / 32) {
    C* row = ps + i * (K + 1);
    C m = static_cast<C>(-CUDART_INF);
    for (int j = lane; j < K; j += 32) m = max_c(m, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = max_c(m, __shfl_xor_sync(0xffffffffu, m, off));
    C sum = 0;
    for (int j = lane; j < K; j += 32) {
      const C ex = exp_c(row[j] - m);
      row[j] = ex;
      sum += ex;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < K; j += 32) row[j] = div_rn(row[j], sum);
  }
  __syncthreads();

  for (int e = tid; e < K * hd; e += kThreads) {
    const int i = e / hd;
    const int d = e - i * hd;
    C acc = 0;
    for (int j = 0; j < K; ++j) acc = fma_rn(ps[i * (K + 1) + j], vs[j * ld + d], acc);
    store_c(o + (row0 + i) * D + col0 + d, acc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int R, int K, int H,
                   int hd, cudaStream_t stream) {
  using C = typename Acc<T>::type;
  const size_t smem = ((size_t)3 * K * (hd + 1) + (size_t)K * (K + 1)) * sizeof(C);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (R / K) * H;
  if (blocks == 0) return cudaSuccess;
  attn_kernel<T><<<blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, K, H, hd, 1.0 / sqrt((double)hd));
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (R, H*hd) contiguous, R a multiple of K; dtype is a DType
// code (attention_common.cuh): float32, bfloat16 or float64 elements.
extern "C" int pdanet_neighbor_attention(const void* q, const void* k, const void* v, void* o,
                                         int R, int K, int H, int hd, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kFloat32: return (int)launch<float>(q, k, v, o, R, K, H, hd, s);
    case kBFloat16: return (int)launch<__nv_bfloat16>(q, k, v, o, R, K, H, hd, s);
    case kFloat64: return (int)launch<double>(q, k, v, o, R, K, H, hd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
