// Greedy NMS walk over a score-sorted IoU matrix for Hopper (sm_90a).
//
// Replaces the TPU kernel pdanet_tpu/ops/pallas/nms.py:
//   greedy_nms_mask_pallas (:70) -> _nms_kernel (:28)
//
// Semantics (held exactly against _greedy_nms_mask_xla,
// pdanet_tpu/ops/nms.py:69-81): keep[i] = valid[i] and no earlier kept j
// has IoU[j, i] > thresh (float32 compare), candidates in score order.
// Any K from 1 to kMaxK (10240).
//
// What bounds it on the H100: the K-step dependency chain, on one SM per
// frame; the bytes are one IoU row per candidate.  Design, after the
// reference's bitmask NMS (OpenPCDet iou3d_nms_kernel.cu:267-311), in two
// launches:
//
// 1. nms_mask_kernel, grid-wide: one warp per (frame, row i) reads row i
//    coalesced and turns IoU[i, c] > thresh into 64-bit suppression words
//    mask[b][i][w] (bit c % 64 of word c / 64), two __ballot_sync a word.
//    Bits at c <= i are 0, so a word left of the diagonal is 0.  Rows, not
//    the transpose: a kept candidate suppresses by its row.
// 2. nms_walk_kernel, one warp per frame: the removed words live in
//    registers, word w on lane w % 32 (WPL a lane: 2 up to K 4096, the
//    instantiation every K <= 4096 runs, and 5 up to K 10240, which the
//    two-stage detectors' proposal layer needs at NMS_PRE_MAXSIZE 9000).
//    The walk
//    takes one block of 64 candidates at a time.  Lane l holds the
//    block's diagonal words of rows 64 w + l and 64 w + 32 + l (loaded one
//    block ahead); every lane resolves the block's 64 candidates in order
//    on the same 64-bit word in registers, taking each diagonal word by
//    __shfl_sync (independent of the chain, so the shuffles run ahead of
//    it): a candidate still standing at its turn is kept and clears the
//    later bits its row sets.  No lane diverges and no CTA barrier is
//    needed: the chain is K / 64 blocks of 64 register steps.  Then every
//    lane ORs the rows of the block's kept candidates into its own words,
//    kBatch rows' loads in flight at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaskWarps = 8;                  // rows a CTA of nms_mask_kernel
constexpr int kMaxWordsPerLane = 5;            // removed words a lane holds, at most
constexpr int kMaxK = 64 * 32 * kMaxWordsPerLane;  // 10240

using u64 = unsigned long long;

__global__ void __launch_bounds__(kMaskWarps * 32)
    nms_mask_kernel(const float* __restrict__ iou, int rows, int K, int W, float thresh,
                    u64* __restrict__ mask) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kMaskWarps + (threadIdx.x >> 5);  // b * K + i
  if (g >= rows) return;  // whole warps only
  const int i = g % K;
  const float* row = iou + (size_t)g * K;
  u64* out = mask + (size_t)g * W;
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    const int c = (w << 6) + lane;
    const bool lo = c > i && c < K && row[c] > thresh;
    const bool hi = c + 32 > i && c + 32 < K && row[c + 32] > thresh;
    const unsigned blo = __ballot_sync(kFull, lo);
    const unsigned bhi = __ballot_sync(kFull, hi);
    if (lane == (w & 31)) out[w] = ((u64)bhi << 32) | blo;
  }
}

__device__ __forceinline__ u64 shfl64(u64 v, int src) {
  const unsigned lo = __shfl_sync(kFull, (unsigned)v, src);
  const unsigned hi = __shfl_sync(kFull, (unsigned)(v >> 32), src);
  return ((u64)hi << 32) | lo;
}

// What lane `lane` holds of block w: the diagonal words of rows 64 w + lane
// and 64 w + 32 + lane, and their valid flags (0 past K).
struct BlockIn {
  u64 d0, d1;
  bool v0, v1;
};

__device__ __forceinline__ BlockIn load_block(const u64* mb, const uint8_t* vb, int K, int W,
                                              int w, int lane) {
  const int i0 = (w << 6) + lane, i1 = i0 + 32;
  BlockIn r;
  r.d0 = i0 < K ? mb[(size_t)i0 * W + w] : 0ull;
  r.d1 = i1 < K ? mb[(size_t)i1 * W + w] : 0ull;
  r.v0 = i0 < K && vb[i0] != 0;
  r.v1 = i1 < K && vb[i1] != 0;
  return r;
}

// WPL: the removed words a lane holds (K <= 64 * 32 * WPL); kBatch: the kept
// rows whose words are loaded at once (WPL * kBatch words in flight a lane).
template <int WPL, int kBatch>
__global__ void __launch_bounds__(32)
    nms_walk_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid, int K,
                    int W, uint8_t* __restrict__ keep) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const u64* mb = mask + (size_t)b * K * W;
  const uint8_t* vb = valid + (size_t)b * K;
  uint8_t* kb = keep + (size_t)b * K;
  u64 rem[WPL];  // removed words lane, lane + 32, ...
  // a lane whose word lies past the row re-reads word W - 1 into a slot no
  // block reads
  int col[WPL];
#pragma unroll
  for (int v = 0; v < WPL; ++v) {
    rem[v] = 0ull;
    col[v] = min(lane + 32 * v, W - 1);
  }
  BlockIn cur = load_block(mb, vb, K, W, 0, lane);
  for (int w = 0; w < W; ++w) {
    BlockIn nxt = cur;
    if (w + 1 < W) nxt = load_block(mb, vb, K, W, w + 1, lane);
    u64 mine = rem[0];  // this lane's word of block w's register slot w / 32
#pragma unroll
    for (int v = 1; v < WPL; ++v)
      if ((w >> 5) == v) mine = rem[v];
    const u64 removed = shfl64(mine, w & 31);
    const u64 vbits = __ballot_sync(kFull, cur.v0) | ((u64)__ballot_sync(kFull, cur.v1) << 32);
    // resolve the block in order: the diagonal word of row t has bits
    // above t only, so bit t of cand is final when its turn comes
    u64 cand = vbits & ~removed;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const u64 d = shfl64(cur.d0, t);
      if ((cand >> t) & 1ull) cand &= ~d;
    }
#pragma unroll
    for (int t = 0; t < 32; ++t) {  // rows 32-63 set bits of the high half only
      const unsigned dh = __shfl_sync(kFull, (unsigned)(cur.d1 >> 32), t);
      if ((cand >> (32 + t)) & 1ull) cand &= ~((u64)dh << 32);
    }
    const int i0 = (w << 6) + lane;
    if (i0 < K) kb[i0] = (uint8_t)((cand >> lane) & 1ull);
    if (i0 + 32 < K) kb[i0 + 32] = (uint8_t)((cand >> (lane + 32)) & 1ull);
    if (w + 1 < W) {
      // OR the kept rows into the later words; a batch short of kBatch
      // repeats its first row, which ORs nothing new
      u64 todo = cand;
      while (todo) {
        const int first = __ffsll((long long)todo) - 1;
        u64 a[kBatch][WPL];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          int t = first;
          if (todo) {
            t = __ffsll((long long)todo) - 1;
            todo &= todo - 1;
          }
          const u64* row = mb + (size_t)((w << 6) + t) * W;
#pragma unroll
          for (int v = 0; v < WPL; ++v) a[u][v] = (v == 0 || W > 32 * v) ? row[col[v]] : 0ull;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int v = 0; v < WPL; ++v) rem[v] |= a[u][v];
      }
    }
    cur = nxt;
  }
}

}  // namespace

// iou: (B, K, K) float32; valid, keep: (B, K) bool (one byte each);
// mask: workspace of B * K * ceil(K / 64) 64-bit words.
extern "C" int pdanet_nms_walk(const float* iou, const uint8_t* valid, int B, int K, float thresh,
                               void* mask, uint8_t* keep, void* stream) {
  if (B == 0 || K == 0) return 0;
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int W = (K + 63) / 64;
  const int rows = B * K;
  u64* words = (u64*)mask;
  nms_mask_kernel<<<(rows + kMaskWarps - 1) / kMaskWarps, kMaskWarps * 32, 0, s>>>(
      iou, rows, K, W, thresh, words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (W <= 64)  // K <= 4096
    nms_walk_kernel<2, 16><<<B, 32, 0, s>>>(words, valid, K, W, keep);
  else
    nms_walk_kernel<5, 8><<<B, 32, 0, s>>>(words, valid, K, W, keep);
  return (int)cudaGetLastError();
}
