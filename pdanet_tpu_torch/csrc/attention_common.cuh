// Helpers shared by the float32 / float64 SIMT neighbour-attention kernels
// (neighbor_attention.cu, neighbor_attention_bwd.cu): arithmetic, 16-byte
// shared-memory vectors, cp.async copies, the unit tiles and the launch
// plan.
//
// C is the element type of the tensors and of every sum and shared-memory
// tile: float for float32, double for float64.  The arithmetic asks for
// round-to-nearest operations explicitly, since the library builds with
// --fmad=false.
//
// Unit tiles.  A unit is one (centre, head): the K rows of one centre in
// the flat (R, H*hd) layout, hd columns from h*hd.  Its tile of one tensor
// is K rows of LD elements in shared memory.  Columns hd..HDP-1 (HDP = hd
// rounded up to W, the elements of 16 bytes) are zero, so that every walk
// over d goes in whole 16-byte vectors and the pad adds exact zeros.  LD
// is HDP, plus W when HDP / W is even: a row is then an odd number of
// 16-byte chunks, so the 16-byte loads of 8 lanes from 8 distinct rows
// fall on 8 distinct bank quads.  Where that pad would not fit in shared
// memory, LD = HDP (bank conflicts, never a refused shape).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace pdanet_attn {

// Warps of a CTA, all on one group of units (chip_smoke.py --sweep builds
// 2, 4 and 8 with -DPDANET_ATTN_WARPS).
#ifndef PDANET_ATTN_WARPS
#define PDANET_ATTN_WARPS 4
#endif
constexpr int kWarps = PDANET_ATTN_WARPS;

// How a CTA splits its work, by KMAX = K rounded up to 16, 32 or 64 (the
// kernels' template argument, so that a lane's scores stay in registers).
template <int KMAX> struct Split {
  static constexpr int UPC = KMAX == 16 ? 2 : 1;  // units per CTA, one per half-warp
  static constexpr int RPL = KMAX == 64 ? 2 : 1;  // rows (columns) per lane and unit
  static constexpr int JPT = KMAX / kWarps;       // score columns per thread and row
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float exp_c(float x) { return expf(x); }
__device__ __forceinline__ double exp_c(double x) { return exp(x); }
__device__ __forceinline__ float max_c(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_c(double a, double b) { return fmax(a, b); }

// W: elements in 16 bytes.  DC: columns a lane holds in registers at a
// time (a chunk of a row, or of an output row).
template <typename C> struct Vec;
template <> struct Vec<float> { static constexpr int W = 4, DC = 16; };
template <> struct Vec<double> { static constexpr int W = 2, DC = 8; };

// 16 bytes of shared memory <-> W registers (p 16-byte aligned)
__device__ __forceinline__ void ld16(float* r, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
}
__device__ __forceinline__ void ld16(double* r, const double* p) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  r[0] = x.x; r[1] = x.y;
}
__device__ __forceinline__ void st16(float* p, const float* r) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ void st16(double* p, const double* r) {
  *reinterpret_cast<double2*>(p) = make_double2(r[0], r[1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies in flight: 16 bytes (both 16-byte aligned), or
// one element; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_elem(double* dst, const double* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a unit's rows are in the flat layout.
struct Unit {
  size_t row0;  // first row of the unit in the flat layout
  int col0;     // first column
};
__device__ __forceinline__ Unit unit_at(int unit, int K, int H, int hd) {
  const int c = unit / H;
  return Unit{(size_t)c * K, (unit - c * H) * hd};
}

// Copy the K x hd slice of unit `unit` of the flat (R, H*hd) tensor g into
// a K x ld tile, the CTA's kWarps * 32 threads issuing cp.async (thread
// tid): 16-byte copies when vec
// (hd a multiple of W and every pointer 16-byte aligned), else one element
// each, zero-filling columns hd..HDP-1.
template <typename C>
__device__ __forceinline__ void load_tile(C* tile, const C* __restrict__ g, int unit, int K,
                                          int H, int hd, int ld, int vec, int tid) {
  constexpr int W = Vec<C>::W;
  const Unit u = unit_at(unit, K, H, hd);
  const int D = H * hd;
  const C* src = g + u.row0 * D + u.col0;
  if (vec) {
    const int per_row = hd / W;
    for (int idx = tid; idx < K * per_row; idx += 32 * kWarps) {
      const int r = idx / per_row;
      const int ch = idx - r * per_row;
      cp_async16(tile + r * ld + ch * W, src + (size_t)r * D + ch * W);
    }
  } else {
    const int hdp = (hd + W - 1) / W * W;
    for (int idx = tid; idx < K * hdp; idx += 32 * kWarps) {
      const int r = idx / hdp;
      const int d = idx - r * hdp;
      const bool real = d < hd;
      cp_async_elem(tile + r * ld + d, src + (size_t)r * D + (real ? d : 0),
                    real ? (int)sizeof(C) : 0);
    }
  }
}

// Write a K x ld tile's K x hd values to unit `unit` of the flat tensor g:
// coalesced, 16-byte stores when vec, by the CTA's threads.  The caller
// has __syncthreads()ed after staging.
template <typename C>
__device__ __forceinline__ void store_tile(C* __restrict__ g, const C* tile, int unit, int K,
                                           int H, int hd, int ld, int vec, int tid) {
  constexpr int W = Vec<C>::W;
  const Unit u = unit_at(unit, K, H, hd);
  const int D = H * hd;
  C* dst = g + u.row0 * D + u.col0;
  if (vec) {
    const int per_row = hd / W;
    for (int idx = tid; idx < K * per_row; idx += 32 * kWarps) {
      const int r = idx / per_row;
      const int ch = idx - r * per_row;
      C x[W];
      ld16(x, tile + r * ld + ch * W);
      st16(dst + (size_t)r * D + ch * W, x);
    }
  } else {
    for (int idx = tid; idx < K * hd; idx += 32 * kWarps) {
      const int r = idx / hd;
      const int d = idx - r * hd;
      dst[(size_t)r * D + d] = tile[r * ld + d];
    }
  }
}

// out[i][chunks of warp w] = sum_j a[i][j] b[j][chunk] (a a K x (K + 1)
// tile, b a K x ld tile), each chunk's sum in j order, times `scale` when
// `scaled`.
template <typename C>
__device__ __forceinline__ void row_times_tile(C* out, const C* a, const C* b, int i, int w,
                                               int K, int hdp, int ld, bool scaled, C scale) {
  constexpr int W = Vec<C>::W, G = Vec<C>::DC / W;
  const int nch = hdp / W;
  for (int t0 = 0; w + kWarps * t0 < nch; t0 += G) {
    C acc[G][W];
#pragma unroll
    for (int t = 0; t < G; ++t)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[t][e] = 0;
    for (int j = 0; j < K; ++j) {
      const C aij = a[i * (K + 1) + j];
#pragma unroll
      for (int t = 0; t < G; ++t) {
        const int ch = w + kWarps * (t0 + t);
        if (ch < nch) {
          C bv[W];
          ld16(bv, b + j * ld + ch * W);
#pragma unroll
          for (int e = 0; e < W; ++e) acc[t][e] = fma_rn(aij, bv[e], acc[t][e]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int ch = w + kWarps * (t0 + t);
      if (ch < nch) {
        if (scaled) {
#pragma unroll
          for (int e = 0; e < W; ++e) acc[t][e] = mul_rn(acc[t][e], scale);
        }
        st16(out + i * ld + ch * W, acc[t]);
      }
    }
  }
}

// ---- host side

constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block may opt in to

// A kernel's launch: the row stride of its tiles and its dynamic shared
// memory.
struct Plan {
  int ld;
  size_t smem;
};

// Vectorised copies need hd a multiple of W and every pointer 16-byte
// aligned.
inline int vec_ok(int hd, int w, const void* const* ptrs, int n) {
  if (hd % w) return 0;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return 0;
  return 1;
}

// Choose ld: the bank pad where it fits, else none; smem_elems(ld) is a
// CTA's elements.  Opts the kernel in to shared memory above 48 KB (once
// per device and size).  Returns the runtime's error, or
// cudaErrorInvalidValue if nothing fits.
template <typename Kern, typename F>
cudaError_t make_plan(Kern kern, int hd, int w, size_t elem, F smem_elems, Plan* p) {
  const int hdp = (hd + w - 1) / w * w;
  const int padded = (hdp / w) % 2 ? hdp : hdp + w;
  p->ld = smem_elems(padded) * elem <= kSmemLimit ? padded : hdp;
  p->smem = smem_elems(p->ld) * elem;
  if (p->smem > kSmemLimit) return cudaErrorInvalidValue;
  static size_t opted[16];  // dynamic shared memory opted in to, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 16) return cudaErrorInvalidDevice;
  if (p->smem > 48 * 1024 && p->smem > opted[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
    if (e != cudaSuccess) return e;
    opted[dev] = p->smem;
  }
  return cudaSuccess;
}

// element type codes of the C interface (bfloat16 runs on the tensor-core
// kernels, which take no code)
enum DType { kFloat32 = 0, kFloat64 = 2 };

}  // namespace pdanet_attn
