// Greedy NMS walk over a score-sorted IoU matrix for Hopper (sm_90a).
//
// Replaces the TPU kernel pdanet_tpu/ops/pallas/nms.py:
//   greedy_nms_mask_pallas (:70) -> _nms_kernel (:28)
//
// Semantics (held exactly against _greedy_nms_mask_xla,
// pdanet_tpu/ops/nms.py:69-81): keep[i] = valid[i] and no earlier kept j
// has IoU[j, i] > thresh (float32 compare), candidates in score order.
//
// What bounds it on the H100: the K-step dependency chain, one
// __syncthreads per candidate; the bytes are one IoU row per kept
// candidate.  Design: one CTA per frame walks i = 0..K-1 in
// running-suppression form -- keep[i] = valid[i] && !sup[i], and when i is
// kept every thread ORs IoU[i, c] > thresh into sup[c] for its columns
// c > i.  The suppression flags live in shared memory and the walk never
// leaves the device, so post-processing has no host sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void nms_kernel(const float* __restrict__ iou, const uint8_t* __restrict__ valid,
                           int K, float thresh, uint8_t* __restrict__ keep) {
  extern __shared__ uint8_t sup[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* m = iou + (size_t)b * K * K;
  const uint8_t* vb = valid + (size_t)b * K;
  uint8_t* kb = keep + (size_t)b * K;
  for (int c = tid; c < K; c += blockDim.x) sup[c] = 0;
  __syncthreads();
  for (int i = 0; i < K; ++i) {
    // sup[i] was last written before the previous step's barrier, and this
    // step writes only columns > i, so one barrier per step suffices
    const bool k_i = vb[i] != 0 && sup[i] == 0;
    if (tid == 0) kb[i] = k_i ? 1 : 0;
    if (k_i) {
      const float* row = m + (size_t)i * K;
      for (int c = i + 1 + tid; c < K; c += blockDim.x)
        if (row[c] > thresh) sup[c] = 1;
    }
    __syncthreads();
  }
}

}  // namespace

// iou: (B, K, K) float32; valid, keep: (B, K) bool (one byte each).
extern "C" int pdanet_nms_walk(const float* iou, const uint8_t* valid, int B, int K, float thresh,
                               uint8_t* keep, void* stream) {
  if (B == 0 || K == 0) return 0;
  int threads = ((K + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  nms_kernel<<<B, threads, K, (cudaStream_t)stream>>>(iou, valid, K, thresh, keep);
  return (int)cudaGetLastError();
}
