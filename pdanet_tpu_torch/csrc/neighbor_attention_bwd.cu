// Per-centre neighbour attention (backward) for Hopper (sm_90a).
//
// Replaces the TPU kernel pdanet_tpu/ops/pallas/attention.py:
//   _neighbor_attention_flat_bwd (:256) -> _attn_bwd_kernel (:98)
//
// Semantics: q, k, v and dO are the flat (R, H*hd) layout of the PDA
// transformer, R = centres * K, the K rows of one centre contiguous; the
// forward is o = softmax(s q k^T) v per centre and head, s = 1/sqrt(hd).
// The softmax is recomputed (nothing is kept from the forward), then
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dP * P)),
//   dQ = s dS K,  dK = s dS^T Q.
// All sums are float32 for float32 and bfloat16 inputs alike (float64 for
// float64 inputs, which exact checks use); dq, dk and dv are written in
// the input type.
//
// What bounds it on the H100: it reads 4 and writes 3 (R, H*hd) tensors
// and does 5 * K * hd multiply-adds per (row, head) -- about K/3 flops per
// byte in float32, so at the shipped K = 16/32 it sits near the memory /
// shared-memory bound, not the FMA rate.  The TPU kernel's 128-row
// block-diagonal masking and 128-lane head panels exist for the MXU and
// have no purpose here.
// Design: one block per (centre, head), as in the forward.  It stages q
// (scaled by s), k, v and dO as K x hd tiles of the sum type in shared memory
// (rows padded to hd + 1 so that a column walk hits distinct banks), and
// P and dP / dS as K x K tiles (rows padded to K + 1).  Each block owns
// its rows of dq, dk and dv, so there are no atomics and the result is
// deterministic.  At K 64 / hd 128 the float32 tiles take 165 KB, above
// the 48 KB default, so the launch opts in to the larger dynamic shared
// memory (float64 tiles take twice that and fit up to K 32 / hd 128).
// Any K <= 64 and hd <= 128 run.  Tensor cores (wgmma) and several
// centres per block are later work.

#include "attention_common.cuh"

namespace {

using namespace pdanet_attn;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
                T* __restrict__ dv, int K, int H, int hd, double scale_d) {
  using C = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);
  const C scale = static_cast<C>(scale_d);
  const int ld = hd + 1;
  const int lp = K + 1;
  C* qs = sm;             // s * q, K x ld
  C* ks = qs + K * ld;    // k
  C* vs = ks + K * ld;    // v
  C* dos = vs + K * ld;   // dO
  C* ps = dos + K * ld;   // P, K x lp
  C* dps = ps + K * lp;   // dP, then dS
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
    dos[r * ld + d] = load_c(dout[gi]);
  }
  __syncthreads();

  // scores S = (s q) k^T and dP = dO v^T, one (i, j) pair per step
  for (int e = tid; e < K * K; e += kThreads) {
    const int i = e / K;
    const int j = e - i * K;
    C s = 0, dp = 0;
    for (int d = 0; d < hd; ++d) {
      s = fma_rn(qs[i * ld + d], ks[j * ld + d], s);
      dp = fma_rn(dos[i * ld + d], vs[j * ld + d], dp);
    }
    ps[i * lp + j] = s;
    dps[i * lp + j] = dp;
  }
  __syncthreads();

  // per row, one warp: P = softmax(S), then dS = P * (dP - sum_j dP P)
  const int lane = tid & 31;
  for (int i = tid >> 5; i < K; i += kThreads / 32) {
    C* prow = ps + i * lp;
    C* drow = dps + i * lp;
    C m = static_cast<C>(-CUDART_INF);
    for (int j = lane; j < K; j += 32) m = max_c(m, prow[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = max_c(m, __shfl_xor_sync(0xffffffffu, m, off));
    C sum = 0;
    for (int j = lane; j < K; j += 32) {
      const C ex = exp_c(prow[j] - m);
      prow[j] = ex;
      sum += ex;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    C dot = 0;
    for (int j = lane; j < K; j += 32) {
      const C p = div_rn(prow[j], sum);
      prow[j] = p;
      dot = fma_rn(drow[j], p, dot);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    for (int j = lane; j < K; j += 32) drow[j] = mul_rn(prow[j], sub_rn(drow[j], dot));
  }
  __syncthreads();

  // dV[j] = sum_i P[i][j] dO[i];  dQ[i] = s sum_j dS[i][j] k[j];
  // dK[j] = sum_i dS[i][j] (s q)[i]
  for (int e = tid; e < K * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    C acc_v = 0, acc_q = 0, acc_k = 0;
    for (int t = 0; t < K; ++t) {
      acc_v = fma_rn(ps[t * lp + r], dos[t * ld + d], acc_v);
      acc_q = fma_rn(dps[r * lp + t], ks[t * ld + d], acc_q);
      acc_k = fma_rn(dps[t * lp + r], qs[t * ld + d], acc_k);
    }
    const size_t gi = (row0 + r) * D + col0 + d;
    store_c(dv + gi, acc_v);
    store_c(dq + gi, mul_rn(acc_q, scale));
    store_c(dk + gi, acc_k);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, int R, int K, int H, int hd, cudaStream_t stream) {
  using C = typename Acc<T>::type;
  const size_t smem = ((size_t)4 * K * (hd + 1) + (size_t)2 * K * (K + 1)) * sizeof(C);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attn_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (R / K) * H;
  if (blocks == 0) return cudaSuccess;
  attn_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dq, (T*)dk, (T*)dv, K, H, hd,
      1.0 / sqrt((double)hd));
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout (inputs) and dq, dk, dv (outputs): (R, H*hd) contiguous,
// R a multiple of K; dtype is a DType code (attention_common.cuh).
extern "C" int pdanet_neighbor_attention_bwd(const void* q, const void* k, const void* v,
                                             const void* dout, void* dq, void* dk, void* dv,
                                             int R, int K, int H, int hd, int dtype,
                                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kFloat32: return (int)launch<float>(q, k, v, dout, dq, dk, dv, R, K, H, hd, s);
    case kBFloat16:
      return (int)launch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, R, K, H, hd, s);
    case kFloat64: return (int)launch<double>(q, k, v, dout, dq, dk, dv, R, K, H, hd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
