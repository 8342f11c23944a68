// Multi-radius first-K ball query for Hopper (sm_90a).
//
// Replaces the TPU kernels pdanet_tpu/ops/pallas/ball_query.py:
//   ball_query_multi_pallas_streamed (:306) -> _bq_stream_kernel (:232), N > 8192
//   ball_query_multi_pallas (:407) -> _bq_kernel (:174), N <= 8192
// The TPU needed two kernels only because of VMEM; one kernel covers both.
//
// Semantics (held exactly against _ball_query_multi_xla,
// pdanet_tpu/ops/ball_query.py:164-188): for each centre and each radius,
// the first K support indices in index order with d2 < r2 (strict), where
// d2 = dx*dx + dy*dy + dz*dz is evaluated left to right without FMA
// contraction and r2 = float32(radius * radius) is computed on the host.
// Unfilled slots repeat the first hit; a centre with no hit gets 0.  The
// result never depends on the order of the cloud (the x-sort of the
// pipeline only makes more of the support provably out of reach).
//
// What bounds it on the H100: reading the support.  The previous design
// gave each centre one warp that streamed the whole support from L2 as
// 12-byte strided loads, sharing nothing: at SA0 b1, 4096 warps each read
// all 16384 points (~805 MB of L1/L2 traffic), because a 0.2 m ball seldom
// fills and the scan cannot stop.
// Design: one CTA of 8 warps per block of 8 * CPW centres (CPW per warp,
// pick_cpw).  The CTA streams the support through shared memory in chunks
// of 4096 points (48 KB), with 16-byte cp.async copies, double-buffered,
// so the support is read once per CTA, not once per centre.  Each chunk is
// cut into 32 tiles of 128 points; where the support spans several chunks
// the warps compute the tiles' bounding boxes from the staged chunk, and
// for each of its centres a warp tests the 32 boxes at once (one lane a
// tile, one ballot) and scans only the tiles that can hold a point within
// the largest radius: the TPU kernel's exact per-chunk AABB skip
// (_bq_stream_kernel, :347-362), per centre and at a finer grain.  The
// skip is exact with no margin (box_lower_bound, distance.cuh).  On the
// x-sorted raw cloud of SA0 ~97 % of a centre's tiles are skipped.  The
// FPS-ordered supports of SA1, SA2 and SA5 fit one chunk, where boxes
// would be wide and skip little: they are scanned whole, from shared
// memory, without the box pass and its barrier.  Kept from the previous
// design: a __ballot_sync + __popc per radius places the hits in index
// order with one counter per radius, all radii share one distance, and a
// centre stops as soon as every radius is full (the CTA stops when all its
// centres are).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "distance.cuh"

namespace {

using pdanet_dist::box_lower_bound;
using pdanet_dist::dist2;

constexpr int kMaxRadii = 4;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;                    // points per bounding box
constexpr int kChunkTiles = 32;               // one lane per tile
constexpr int kChunk = kTile * kChunkTiles;   // points per staged chunk
constexpr unsigned kFull = 0xffffffffu;

struct BallQueryArgs {
  int n_radii;
  float r2[kMaxRadii];
  int k[kMaxRadii];
  int32_t* out[kMaxRadii];
  float r2max;
  unsigned long long* stats;  // null, or (tile tests, tiles in reach, tiles scanned)
};

// float <-> int keeping the order, for min/max through redux.sync
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Stage `words` floats from global `src` to shared `dst` (16-byte aligned):
// 16-byte copies where `src` is 16-byte aligned, 4-byte copies for the tail
// and for a misaligned source.  One commit group per thread.
__device__ __forceinline__ void stage(float* dst, const float* src, int words) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = words >> 2;
    for (int v = threadIdx.x; v < n16; v += kThreads) cp_async16(dst + 4 * v, src + 4 * v);
    done = n16 << 2;
  }
  for (int w = done + threadIdx.x; w < words; w += kThreads) cp_async4(dst + w, src + w);
  cp_async_commit();
}

// Grid (ceil(M / (8 * CPW)), B).  Warp w of block x holds centres
// (x * 8 + w) * CPW .. + CPW - 1 of frame blockIdx.y.  chunk: points per
// staged chunk, a multiple of kTile, at most kChunk.
template <int CPW>
__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centres, int N,
                  int M, int chunk, BallQueryArgs a) {
  extern __shared__ __align__(16) float buf[];  // (1 or 2) x chunk x 3, AoS as in global
  __shared__ float box[6][kChunkTiles];         // lo x, y, z, hi x, y, z of the chunk's tiles

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int m0 = (blockIdx.x * kWarps + warp) * CPW;
  const float* p = xyz + (size_t)b * N * 3;
  const unsigned lt_mask = (1u << lane) - 1u;

  float cx[CPW], cy[CPW], cz[CPW];
  int cnt[CPW][kMaxRadii], first[CPW][kMaxRadii];
  bool done[CPW];
#pragma unroll
  for (int q = 0; q < CPW; ++q) {
    const int m = m0 + q;
    done[q] = m >= M;
    const float* c = centres + ((size_t)b * M + (done[q] ? 0 : m)) * 3;
    cx[q] = c[0];
    cy[q] = c[1];
    cz[q] = c[2];
#pragma unroll
    for (int r = 0; r < kMaxRadii; ++r) {
      cnt[q][r] = 0;
      first[q][r] = 0;
    }
  }
  unsigned long long n_tested = 0, n_reach = 0, n_scanned = 0;

  const int n_chunks = chunk > 0 ? (N + chunk - 1) / chunk : 0;
  if (n_chunks > 0) stage(buf, p, min(chunk, N) * 3);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      const int nb = (c + 1) * chunk;
      stage(buf + ((c + 1) & 1) * chunk * 3, p + (size_t)nb * 3, min(chunk, N - nb) * 3);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c is staged for every thread
    const float* s = buf + (c & 1) * chunk * 3;
    const int base = c * chunk;
    const int np = min(chunk, N - base);
    const int nt = (np + kTile - 1) / kTile;

    // boxes only where the support spans several chunks (SA0's raw cloud):
    // a one-chunk support (SA1, SA2, SA5) is scanned whole, without the
    // box pass and its barrier
    const bool boxed = n_chunks > 1;
    for (int tl = warp; boxed && tl < nt; tl += kWarps) {
      float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
      float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const int i = tl * kTile + u * 32 + lane;
        if (i < np) {
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            lo[d] = fminf(lo[d], s[i * 3 + d]);
            hi[d] = fmaxf(hi[d], s[i * 3 + d]);
          }
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float l = unordered(__reduce_min_sync(kFull, ordered(lo[d])));
        const float h = unordered(__reduce_max_sync(kFull, ordered(hi[d])));
        if (lane == 0) {
          box[d][tl] = l;
          box[3 + d][tl] = h;
        }
      }
    }
    if (boxed) __syncthreads();  // the chunk's boxes are in place

#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      if (done[q]) continue;  // warp-uniform
      bool reach = lane < nt;
      if (boxed && reach) {
        // every point of a tile whose bound is >= r2max has d2 >= r2 for
        // every radius, so skipping it changes no index
        const float lb = box_lower_bound(box[0][lane], box[1][lane], box[2][lane],
                                         box[3][lane], box[4][lane], box[5][lane], cx[q],
                                         cy[q], cz[q]);
        reach = !(lb >= a.r2max);  // a NaN bound keeps the tile
      }
      unsigned need = __ballot_sync(kFull, reach);
      n_tested += nt;
      n_reach += __popc(need);
      while (need && !done[q]) {
        const int tl = __ffs(need) - 1;
        need &= need - 1;
        ++n_scanned;
        // the tile's four 32-point groups side by side, then their hits in
        // index order
        float d2[kTile / 32];
#pragma unroll
        for (int u = 0; u < kTile / 32; ++u) {
          const int il = tl * kTile + u * 32 + lane;
          d2[u] = CUDART_INF_F;  // no hit past the end of the support
          if (il < np)
            d2[u] = dist2(cx[q], cy[q], cz[q], s[il * 3 + 0], s[il * 3 + 1], s[il * 3 + 2]);
        }
        const size_t row = (size_t)b * M + m0 + q;
#pragma unroll
        for (int u = 0; u < kTile / 32; ++u) {
          const int i = base + tl * kTile + u * 32 + lane;
          bool all_full = true;
#pragma unroll
          for (int r = 0; r < kMaxRadii; ++r) {
            if (r < a.n_radii) {
              const unsigned hits = __ballot_sync(kFull, d2[u] < a.r2[r]);
              if (cnt[q][r] < a.k[r] && hits) {
                if (cnt[q][r] == 0) first[q][r] = i - lane + __ffs((int)hits) - 1;
                const int pos = cnt[q][r] + __popc(hits & lt_mask);
                if (((hits >> lane) & 1u) && pos < a.k[r]) a.out[r][row * a.k[r] + pos] = i;
                cnt[q][r] += __popc(hits);
              }
              all_full = all_full && cnt[q][r] >= a.k[r];
            }
          }
          if (all_full) {  // counters are warp-uniform
            done[q] = true;
            break;
          }
        }
      }
    }
    bool warp_done = true;
#pragma unroll
    for (int q = 0; q < CPW; ++q) warp_done = warp_done && done[q];
    // every warp is past its reads of buffer c & 1 before iteration c + 1
    // stages chunk c + 2 into it; and the CTA stops when all its centres are full
    if (__syncthreads_and(warp_done)) break;
  }
  cp_async_wait<0>();  // no copy may land after the CTA has left

#pragma unroll
  for (int q = 0; q < CPW; ++q) {
    const int m = m0 + q;
    if (m >= M) continue;
    const size_t row = (size_t)b * M + m;
#pragma unroll
    for (int r = 0; r < kMaxRadii; ++r) {
      if (r < a.n_radii) {
        const int filled = cnt[q][r] < a.k[r] ? cnt[q][r] : a.k[r];
        for (int s = filled + lane; s < a.k[r]; s += 32) a.out[r][row * a.k[r] + s] = first[q][r];
      }
    }
  }
  if (a.stats != nullptr && lane == 0) {
    atomicAdd(a.stats + 0, n_tested);
    atomicAdd(a.stats + 1, n_reach);
    atomicAdd(a.stats + 2, n_scanned);
  }
}

// Centres per warp (chip_smoke.py --sweep on the H100): 2 where staging
// the support dominates (a raw cloud of >= 8192 points, scanned by >= 4096
// centres, so that the grid still holds >= 256 CTAs), else 1: the scan of
// a centre is then the larger part, and more CTAs spread it over the SMs.
// A sweep build forces one with -DPDANET_BQ_CPW=1 or 2.
int pick_cpw(int N, long long centres) {
#ifdef PDANET_BQ_CPW
  return PDANET_BQ_CPW;
#else
  return N >= 8192 && centres >= 4096 ? 2 : 1;
#endif
}

template <int CPW>
cudaError_t launch(const float* xyz, const float* centres, int B, int N, int M,
                   const BallQueryArgs& a, cudaStream_t stream) {
  const int chunk = N >= kChunk ? kChunk : ((N + kTile - 1) / kTile) * kTile;
  const int stages = N > chunk ? 2 : 1;
  const int smem = stages * chunk * 3 * (int)sizeof(float);
  // above 48 KB a block, static (the tile boxes) and dynamic together,
  // the launch needs the opt-in; one chunk of 4096 points alone is 48 KB
  if (smem + (int)(6 * kChunkTiles * sizeof(float)) > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ball_query_kernel<CPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((M + kWarps * CPW - 1) / (kWarps * CPW)), (unsigned)B);
  ball_query_kernel<CPW><<<grid, kThreads, smem, stream>>>(xyz, centres, N, M, chunk, a);
  return cudaGetLastError();
}

}  // namespace

// xyz: (B, N, 3) float32; centres: (B, M, 3) float32; r2, k: n_radii host
// values; outs: n_radii device pointers to (B, M, k[r]) int32; stats:
// null, or three device counters the kernel adds to (tile tests, tiles
// within reach, tiles scanned).
extern "C" int pdanet_ball_query(const float* xyz, const float* centres, int B, int N, int M,
                                 int n_radii, const float* r2, const int* k, void* const* outs,
                                 unsigned long long* stats, void* stream) {
  if (n_radii < 1 || n_radii > kMaxRadii) return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return 0;
  BallQueryArgs a;
  a.n_radii = n_radii;
  a.r2max = r2[0];
  for (int r = 0; r < kMaxRadii; ++r) {
    a.r2[r] = r < n_radii ? r2[r] : 0.f;
    a.k[r] = r < n_radii ? k[r] : 0;
    a.out[r] = r < n_radii ? (int32_t*)outs[r] : nullptr;
    if (r < n_radii) a.r2max = fmaxf(a.r2max, r2[r]);
  }
  a.stats = stats;
  cudaStream_t s = (cudaStream_t)stream;
  if (pick_cpw(N, (long long)B * M) == 2) return (int)launch<2>(xyz, centres, B, N, M, a, s);
  return (int)launch<1>(xyz, centres, B, N, M, a, s);
}
