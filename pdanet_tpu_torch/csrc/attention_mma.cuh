// Tensor-core building blocks of the bfloat16 neighbour-attention kernels
// (neighbor_attention_mma.cu, neighbor_attention_bwd_mma.cu) for Hopper
// (sm_90a): 16-byte cp.async copies, ldmatrix, mma.sync m16n8k16 with
// bfloat16 operands and float32 accumulators, and the tile geometry they
// share.
//
// The unit of work is one (centre, head): the K rows of one centre in the
// flat (R, H*hd) layout, hd columns from h*hd.  Each row segment is hd * 2
// bytes of one row, so a unit is K contiguous runs of 32-256 bytes.  A
// unit's tile lives in shared memory as KP x hd bfloat16, KP = K rounded up
// to 16; rows K..KP-1 are zero-filled by the copy.  Rows are padded by 16
// bytes (LD = hd + 8 elements): a row is then an odd number of 16-byte
// chunks, so the 8 row addresses of one ldmatrix phase fall on 8 distinct
// bank quads and the loads have no bank conflicts.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane = 4 g + t.  A
// (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g,
// 2t+8..), a3 = (g+8, 2t+8..).  B (16 x 8): b0 = (k 2t..2t+1, n g), b1 =
// (k 2t+8.., n g).  C (16 x 8, float32): c0 c1 = (g, 2t..2t+1), c2 c3 =
// (g+8, 2t..).  Two C tiles side by side are one A tile, which is how P
// and dS go from the accumulators into the next product without leaving
// registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace pdanet_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b, 16 x 8 x 16, bfloat16 in, float32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bfloat16, round to nearest even; lo
// is the lower column
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a register of two bfloat16 times s (a float that is itself a bfloat16
// value), rounded back to bfloat16: the product of two bfloat16 is exact
// in float32, so this is one rounding, as a bfloat16 multiply does
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  float2 f = __bfloat1622float2(v);
  return pack_bf16(__fmul_rn(f.x, s), __fmul_rn(f.y, s));
}

// Geometry of one unit's tile in shared memory.
template <int KP, int HD>
struct Tile {
  static constexpr int LD = HD + 8;          // row stride, elements
  static constexpr int ELEMS = KP * LD;      // one K x hd tile
  static constexpr int CHUNKS = HD / 8;      // 16-byte chunks per row
  static_assert(KP % 16 == 0 && KP <= 64, "KP");
  static_assert(HD % 16 == 0 && HD <= 128, "HD");
};

// Copy one unit's K x HD slice of a flat (R, D) tensor into a KP x LD
// tile, the whole warp issuing 16-byte cp.async; rows K..KP-1 are zeros.
template <int KP, int HD>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ g, size_t row0,
                                          int col0, int K, int D, int lane) {
  using T = Tile<KP, HD>;
  static_assert(KP * T::CHUNKS % 32 == 0, "whole warp passes");
#pragma unroll
  for (int it = 0; it < KP * T::CHUNKS / 32; ++it) {
    const int idx = it * 32 + lane;
    const int r = idx / T::CHUNKS;
    const int ch = idx - r * T::CHUNKS;
    const bool real = r < K;
    const bf16* src = g + (row0 + (real ? r : 0)) * D + col0 + ch * 8;
    cp_async16(tile + r * T::LD + ch * 8, src, real ? 16 : 0);
  }
}

// Write rows r0..r0+15 (those < K) of a staged tile to the flat (R, D)
// tensor with 16-byte stores.  The caller has __syncwarp()ed after staging.
template <int KP, int HD>
__device__ __forceinline__ void store_rows16(bf16* __restrict__ g, const bf16* tile, int r0,
                                             size_t row0, int col0, int K, int D, int lane) {
  using T = Tile<KP, HD>;
#pragma unroll
  for (int it = 0; it < T::CHUNKS / 2; ++it) {
    const int idx = it * 32 + lane;
    const int r = r0 + idx / T::CHUNKS;
    const int ch = idx % T::CHUNKS;
    if (r < K)
      *reinterpret_cast<uint4*>(g + (row0 + r) * D + col0 + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + r * T::LD + ch * 8);
  }
}

// Stage a 16 x HD float32 accumulator (HD / 8 C tiles) as bfloat16 into
// rows r0..r0+15 of a tile.
template <int KP, int HD>
__device__ __forceinline__ void stage_rows16(bf16* tile, const float (&acc)[HD / 8][4], int r0,
                                             int lane) {
  using T = Tile<KP, HD>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(tile + (r0 + g) * T::LD + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<uint32_t*>(tile + (r0 + g + 8) * T::LD + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

// A fragment of the 16 x 16 block at (r0, c0) of a row-major tile with
// row stride ld (elements).
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile, int ld, int r0, int c0,
                                       int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// A fragment of the 16 x 16 block at (r0, c0) of the transpose of a
// row-major tile: A[r][c] = tile[c][r].
__device__ __forceinline__ void ldsm_a_trans(uint32_t (&a)[4], const bf16* tile, int ld, int r0,
                                             int c0, int lane) {
  ldsm_x4_t(a, tile + (c0 + (lane & 7) + (lane >> 4) * 8) * ld + r0 + ((lane >> 3) & 1) * 8);
}

// B fragments of rows j0..j0+15 of a row-major KP x HD tile used as the
// (k = row, n = column) operand, columns d0..d0+15: b[0], b[1] for the n
// tile d0, b[2], b[3] for d0 + 8.
template <int KP, int HD>
__device__ __forceinline__ void ldsm_b_trans(uint32_t (&b)[4], const bf16* tile, int j0, int d0,
                                             int lane) {
  using T = Tile<KP, HD>;
  ldsm_x4_t(b, tile + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * T::LD + d0 + (lane >> 4) * 8);
}

// acc (16 x KP) = A (rows r0..r0+15 of a_tile, hd wide) times b_tile^T
// (b_tile: KP rows, hd wide), both KP x HD tiles.  With kScaleA the A
// fragments are first multiplied by s and rounded to bfloat16 (the TPU
// kernel's bf16(s q)).
template <int KP, int HD, bool kScaleA>
__device__ __forceinline__ void rows_times_tileT(float (&acc)[KP / 8][4], const bf16* a_tile,
                                                 const bf16* b_tile, int r0, float s, int lane) {
  using T = Tile<KP, HD>;
#pragma unroll
  for (int nt = 0; nt < KP / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_a(a, a_tile, T::LD, r0, kk * 16, lane);
    if (kScaleA) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = scale_bf16x2(a[i], s);
    }
#pragma unroll
    for (int nj = 0; nj < KP / 16; ++nj) {
      uint32_t b[4];
      ldsm_x4(b, b_tile + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * T::LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * nj], a, b[0], b[1]);
      mma16816(acc[2 * nj + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x HD) = A (16 x KP, given as KP / 16 fragments) times tile
// (KP x HD, row-major).
template <int KP, int HD>
__device__ __forceinline__ void frags_times_tile(float (&acc)[HD / 8][4],
                                                 const uint32_t (&a)[KP / 16][4], const bf16* tile,
                                                 int lane) {
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk) {
#pragma unroll
    for (int nd = 0; nd < HD / 16; ++nd) {
      uint32_t b[4];
      ldsm_b_trans<KP, HD>(b, tile, kk * 16, nd * 16, lane);
      mma16816(acc[2 * nd], a[kk], b[0], b[1]);
      mma16816(acc[2 * nd + 1], a[kk], b[2], b[3]);
    }
  }
}

// In place, the 16 x KP scores of a row tile (KP / 8 C tiles) -> the
// row softmax in float32, columns >= K (padding) -> 0.  This lane holds
// rows g (sc[.][0..1]) and g + 8 (sc[.][2..3]) at columns nt * 8 + 2t +
// {0, 1}; a row's max and sum go over the quad of lanes t = 0..3.  exp is
// the hardware's ex2.approx (__expf, relative error ~1e-6 at the scores'
// range) and P = e * (1 / sum): both within a float32 ulp or few of the
// TPU kernel's exp and e / sum (:89-90), far below the bfloat16 rounding
// of P that follows.
template <int KP>
__device__ __forceinline__ void softmax_rows(float (&sc)[KP / 8][4], int K, int lane) {
  const int t = lane & 3;
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int nt = 0; nt < KP / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (nt * 8 + 2 * t + e >= K) sc[nt][e] = sc[nt][2 + e] = -CUDART_INF_F;
      mx0 = fmaxf(mx0, sc[nt][e]);
      mx1 = fmaxf(mx1, sc[nt][2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < KP / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[nt][e] = __expf(__fsub_rn(sc[nt][e], mx0));  // exp(-inf) = 0
      sc[nt][2 + e] = __expf(__fsub_rn(sc[nt][2 + e], mx1));
      sum0 = __fadd_rn(sum0, sc[nt][e]);
      sum1 = __fadd_rn(sum1, sc[nt][2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, off));
    sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, off));
  }
  const float inv0 = __frcp_rn(sum0), inv1 = __frcp_rn(sum1);
#pragma unroll
  for (int nt = 0; nt < KP / 8; ++nt) {
    sc[nt][0] = __fmul_rn(sc[nt][0], inv0);
    sc[nt][1] = __fmul_rn(sc[nt][1], inv0);
    sc[nt][2] = __fmul_rn(sc[nt][2], inv1);
    sc[nt][3] = __fmul_rn(sc[nt][3], inv1);
  }
}

// Two side-by-side float32 C tiles (columns 16 kk .. 16 kk + 15 of a row
// tile) -> the bfloat16 A fragment of that 16 x 16 block.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ---- host side

// Call f(KP, HD) with the tile shape of (K, hd) as integral constants: K
// <= 64 rounded up to 16, hd a multiple of 16 up to 128.  Returns `bad`
// for any other shape.
template <int KP, typename R, typename F>
R with_hd(int hd, R bad, F&& f) {
  using std::integral_constant;
  switch (hd) {
    case 16: return f(integral_constant<int, KP>{}, integral_constant<int, 16>{});
    case 32: return f(integral_constant<int, KP>{}, integral_constant<int, 32>{});
    case 48: return f(integral_constant<int, KP>{}, integral_constant<int, 48>{});
    case 64: return f(integral_constant<int, KP>{}, integral_constant<int, 64>{});
    case 80: return f(integral_constant<int, KP>{}, integral_constant<int, 80>{});
    case 96: return f(integral_constant<int, KP>{}, integral_constant<int, 96>{});
    case 112: return f(integral_constant<int, KP>{}, integral_constant<int, 112>{});
    case 128: return f(integral_constant<int, KP>{}, integral_constant<int, 128>{});
    default: return bad;
  }
}

template <typename R, typename F>
R with_shape(int K, int hd, R bad, F&& f) {
  if (K < 1 || K > 64) return bad;
  switch ((K + 15) / 16) {
    case 1: return with_hd<16>(hd, bad, f);
    case 2: return with_hd<32>(hd, bad, f);
    case 3: return with_hd<48>(hd, bad, f);
    default: return with_hd<64>(hd, bad, f);
  }
}

// One-warp CTAs of `kern` (with `smem` bytes of dynamic shared memory)
// resident per SM on the current device, after opting in to shared memory
// above 48 KB; the first call per device asks the runtime and keeps the
// answer in cache[device] (16 entries).  Returns the runtime's error, if any.
template <typename Kern>
cudaError_t resident_per_sm(Kern kern, size_t smem, int* cache, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 16) return cudaErrorInvalidDevice;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (cache[dev] == 0) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, 32, smem);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = n;
  }
  *per_sm = cache[dev];
  return cudaSuccess;
}

}  // namespace pdanet_mma
