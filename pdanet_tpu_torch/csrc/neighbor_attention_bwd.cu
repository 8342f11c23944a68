// Per-centre neighbour attention (backward) for Hopper (sm_90a).
//
// Replaces the TPU kernel pdanet_tpu/ops/pallas/attention.py:
//   _neighbor_attention_flat_bwd (:256) -> _attn_bwd_kernel (:98)
//
// This SIMT kernel takes float32 and float64; bfloat16 runs on the tensor
// cores in neighbor_attention_bwd_mma.cu.  float32 stays here because
// tensor cores in float32 mean TF32; float64 is for the exact train-step
// check against the CPU.
//
// Semantics: q, k, v and dO are the flat (R, H*hd) layout of the PDA
// transformer, R = centres * K, the K rows of one centre contiguous; the
// forward is o = softmax(s q k^T) v per centre and head, s = 1/sqrt(hd).
// The softmax is recomputed (nothing is kept from the forward), then
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dP * P)),
//   dQ = s dS K,  dK = s dS^T Q  (as dS^T (s Q)).
// All sums are in the input type, each FMA chain in d, j or i order.
//
// What bounds it on the H100: bytes.  It reads 4 and writes 3 (R, H*hd)
// tensors and does 5 K multiply-adds per element of one tensor: 7 *
// 131072 * 256 * 4 bytes = 940 MB at SA1 B=4 K 32 in float32, 0.280 ms at
// 3.35 TB/s, against 0.16 ms of float32 FMAs.  The TPU kernel's 128-row
// block-diagonal masking and 128-lane head panels exist for the MXU and
// have no purpose here.
//
// Design, as in the forward (neighbor_attention.cu): a CTA of kWarps = 4
// warps per group of units (two at K <= 16, one per half-warp), q, k, v
// and dO tiles brought by cp.async, the operand that differs per lane in
// registers and the one a warp shares as broadcast 16-byte loads.
// - The CTA scales the q tiles by s in place.
// - Row phase: lane i owns row i (and i + 32 at K > 32), warp w the
//   columns j = w, w + 4, ...  In one walk over d the lane forms S[i][j]
//   and dP[i][j] from register chunks of (s q)[i] and dO[i] against
//   broadcast k[j] and v[j].  Softmax and the row dot rowsum(dP * P) take
//   the four warps' partials through a small shared array.  P and dS go
//   to two K x (K + 1) tiles.
// - dQ[i] = s sum_j dS[i][j] k[j], warp w taking the 16-byte column
//   chunks w, w + 4, ...: dS[i][j] at lane-distinct addresses, k broadcast;
//   staged in the v tile (free after dP) and written with coalesced stores.
// - Column phase: lane j owns column j, warp w the same column chunks:
//   dV[j] = sum_i P[i][j] dO[i] and dK[j] = sum_i dS[i][j] (s q)[i], P and
//   dS at lane-distinct addresses, dO[i] and (s q)[i] broadcast; dK into the
//   k tile, dV into the v tile, then written with coalesced stores.
// Each unit owns its rows of dq, dk and dv: no atomics, deterministic.
// Shared memory per unit: 4 K LD + 2 K (K + 1) elements (43 KB at K 32 /
// hd 64 in float32, 165 KB at K 64 / hd 128; the row partials live in
// the dS tile until dS is formed); float64 takes every shape whose tiles
// fit in 227 KB (all of K <= 32 with hd <= 128).  Any K <= 64 and hd <= 128 run in float32.

#include <cmath>

#include "attention_common.cuh"

namespace {

using namespace pdanet_attn;

// One unit's tiles: q (scaled in place), k, v, dO (K x ld), then P and dS
// (K x (K + 1), each rounded up to W).  Until dS is formed, its tile holds
// the kWarps x K row partials (max, sum, dot), so it takes at least 4 K.
template <typename C>
struct Tiles {
  C *q, *k, *v, *dout, *p, *ds;
  static __host__ __device__ __forceinline__ int square(int K) {
    return (K * (K + 1) + Vec<C>::W - 1) / Vec<C>::W * Vec<C>::W;
  }
  static __host__ __device__ __forceinline__ int ds_elems(int K) {
    return square(K) > kWarps * K ? square(K) : kWarps * K;
  }
  static __host__ __device__ __forceinline__ size_t elems(int K, int ld) {
    return (size_t)4 * K * ld + square(K) + ds_elems(K);
  }
  __device__ __forceinline__ Tiles(C* base, int K, int ld) {
    const int tile = K * ld;
    q = base;
    k = q + tile;
    v = k + tile;
    dout = v + tile;
    p = dout + tile;
    ds = p + square(K);
  }
};

template <typename C, int KMAX>
__host__ __device__ __forceinline__ size_t cta_elems(int K, int ld) {
  return Split<KMAX>::UPC * Tiles<C>::elems(K, ld);
}

// sc[t] = (s q)[i] . k[j] and dp[t] = dO[i] . v[j] for this warp's columns
// j = w + kWarps t < K, in one walk over d.
template <typename C, int JPT>
__device__ __forceinline__ void scores_dp_row(C (&sc)[JPT], C (&dp)[JPT], const Tiles<C>& t,
                                              int i, int w, int K, int hdp, int ld) {
  constexpr int W = Vec<C>::W, DC = Vec<C>::DC;
#pragma unroll
  for (int n = 0; n < JPT; ++n) sc[n] = dp[n] = 0;
  for (int d0 = 0; d0 < hdp; d0 += DC) {
    C qr[DC], dr[DC];
#pragma unroll
    for (int c = 0; c < DC; c += W)
      if (d0 + c < hdp) {
        ld16(qr + c, t.q + i * ld + d0 + c);
        ld16(dr + c, t.dout + i * ld + d0 + c);
      }
#pragma unroll
    for (int n = 0; n < JPT; ++n) {
      const int j = w + kWarps * n;
      if (j < K) {
#pragma unroll
        for (int c = 0; c < DC; c += W)
          if (d0 + c < hdp) {
            C kv[W], vv[W];
            ld16(kv, t.k + j * ld + d0 + c);
            ld16(vv, t.v + j * ld + d0 + c);
#pragma unroll
            for (int e = 0; e < W; ++e) {
              sc[n] = fma_rn(qr[c + e], kv[e], sc[n]);
              dp[n] = fma_rn(dr[c + e], vv[e], dp[n]);
            }
          }
      }
    }
  }
}

// Column phase for column j: dV[j] into row j of the v tile and dK[j] into
// row j of the k tile, this warp's column chunks.
template <typename C>
__device__ __forceinline__ void col_dk_dv(const Tiles<C>& t, int j, int w, int K, int hdp,
                                          int ld) {
  constexpr int W = Vec<C>::W, G = Vec<C>::DC / W;
  const int nch = hdp / W;
  for (int t0 = 0; w + kWarps * t0 < nch; t0 += G) {
    C av[G][W], ak[G][W];
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int e = 0; e < W; ++e) av[n][e] = ak[n][e] = 0;
    for (int i = 0; i < K; ++i) {
      const C pij = t.p[i * (K + 1) + j];
      const C dsij = t.ds[i * (K + 1) + j];
#pragma unroll
      for (int n = 0; n < G; ++n) {
        const int ch = w + kWarps * (t0 + n);
        if (ch < nch) {
          C ov[W], qv[W];
          ld16(ov, t.dout + i * ld + ch * W);
          ld16(qv, t.q + i * ld + ch * W);
#pragma unroll
          for (int e = 0; e < W; ++e) {
            av[n][e] = fma_rn(pij, ov[e], av[n][e]);
            ak[n][e] = fma_rn(dsij, qv[e], ak[n][e]);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < G; ++n) {
      const int ch = w + kWarps * (t0 + n);
      if (ch < nch) {
        st16(t.v + j * ld + ch * W, av[n]);
        st16(t.k + j * ld + ch * W, ak[n]);
      }
    }
  }
}

template <typename C, int KMAX>
__global__ void __launch_bounds__(32 * kWarps)
attn_bwd_kernel(const C* __restrict__ q, const C* __restrict__ k, const C* __restrict__ v,
                const C* __restrict__ dout, C* __restrict__ dq, C* __restrict__ dk,
                C* __restrict__ dv, int K, int H, int hd, int ld, int units, int vec, C scale) {
  using S = Split<KMAX>;
  constexpr int W = Vec<C>::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const size_t ue = Tiles<C>::elems(K, ld);
  const int hdp = (hd + W - 1) / W * W;
  const int g = blockIdx.x;
#pragma unroll
  for (int uu = 0; uu < S::UPC; ++uu) {
    const int unit = g * S::UPC + uu;
    if (unit < units) {
      const Tiles<C> t(sm + uu * ue, K, ld);
      load_tile(t.q, q, unit, K, H, hd, ld, vec, tid);
      load_tile(t.k, k, unit, K, H, hd, ld, vec, tid);
      load_tile(t.v, v, unit, K, H, hd, ld, vec, tid);
      load_tile(t.dout, dout, unit, K, H, hd, ld, vec, tid);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int uu = 0; uu < S::UPC; ++uu) {  // q -> s q, pad columns stay 0
    C* qt = sm + uu * ue;
    for (int idx = tid; idx < K * hdp; idx += 32 * kWarps) {
      const int r = idx / hdp;
      const int d = idx - r * hdp;
      qt[r * ld + d] = mul_rn(qt[r * ld + d], scale);
    }
  }
  __syncthreads();

  const int u = S::UPC == 2 ? lane >> 4 : 0;     // this lane's unit in the group
  const int r0 = S::UPC == 2 ? lane & 15 : lane;  // and its first row / column
  const bool mine = g * S::UPC + u < units;
  const Tiles<C> t(sm + u * ue, K, ld);
  const int lp = K + 1;
  C* red = t.ds;  // kWarps x K partials of this unit's rows: max, sum, dot

  C sc[S::RPL][S::JPT], dp[S::RPL][S::JPT], m[S::RPL];
#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) {
      scores_dp_row<C, S::JPT>(sc[rr], dp[rr], t, i, w, K, hdp, ld);
      C mx = static_cast<C>(-CUDART_INF);
#pragma unroll
      for (int n = 0; n < S::JPT; ++n)
        if (w + kWarps * n < K) mx = max_c(mx, sc[rr][n]);
      red[w * K + i] = mx;
    }
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) {
      m[rr] = red[i];
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww) m[rr] = max_c(m[rr], red[ww * K + i]);
    }
  }
  __syncthreads();  // every max read: the partials' space takes the sums
#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) {
      C sum = 0;
#pragma unroll
      for (int n = 0; n < S::JPT; ++n)
        if (w + kWarps * n < K) {
          sc[rr][n] = exp_c(sub_rn(sc[rr][n], m[rr]));
          sum = add_rn(sum, sc[rr][n]);
        }
      red[w * K + i] = sum;
    }
  }
  __syncthreads();
  C dot[S::RPL];
#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) {
      C sum = red[i];
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww) sum = add_rn(sum, red[ww * K + i]);
      dot[rr] = 0;
#pragma unroll
      for (int n = 0; n < S::JPT; ++n) {
        const int j = w + kWarps * n;
        if (j < K) {
          sc[rr][n] = div_rn(sc[rr][n], sum);  // P
          t.p[i * lp + j] = sc[rr][n];
          dot[rr] = fma_rn(dp[rr][n], sc[rr][n], dot[rr]);
        }
      }
    }
  }
  __syncthreads();  // every sum read: the partials' space takes the dots
#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) red[w * K + i] = dot[rr];
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) {
      dot[rr] = red[i];
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww) dot[rr] = add_rn(dot[rr], red[ww * K + i]);
    }
  }
  __syncthreads();  // every dot read: the dS tile is free
#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int i = r0 + 32 * rr;
    if (mine && i < K) {
#pragma unroll
      for (int n = 0; n < S::JPT; ++n) {
        const int j = w + kWarps * n;
        if (j < K) t.ds[i * lp + j] = mul_rn(sc[rr][n], sub_rn(dp[rr][n], dot[rr]));
      }
    }
  }
  __syncthreads();  // P and dS complete; v free

#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {  // dQ into the v tile
    const int i = r0 + 32 * rr;
    if (mine && i < K) row_times_tile(t.v, t.ds, t.k, i, w, K, hdp, ld, true, scale);
  }
  __syncthreads();
#pragma unroll
  for (int uu = 0; uu < S::UPC; ++uu)
    if (g * S::UPC + uu < units)
      store_tile(dq, Tiles<C>(sm + uu * ue, K, ld).v, g * S::UPC + uu, K, H, hd, ld, vec, tid);
  __syncthreads();  // k and v free

#pragma unroll
  for (int rr = 0; rr < S::RPL; ++rr) {
    const int j = r0 + 32 * rr;
    if (mine && j < K) col_dk_dv<C>(t, j, w, K, hdp, ld);
  }
  __syncthreads();
#pragma unroll
  for (int uu = 0; uu < S::UPC; ++uu)
    if (g * S::UPC + uu < units) {
      const Tiles<C> tu(sm + uu * ue, K, ld);
      store_tile(dk, tu.k, g * S::UPC + uu, K, H, hd, ld, vec, tid);
      store_tile(dv, tu.v, g * S::UPC + uu, K, H, hd, ld, vec, tid);
    }
}

template <typename C, int KMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, int R, int K, int H, int hd, cudaStream_t stream) {
  constexpr int UPC = Split<KMAX>::UPC;
  const int units = (R / K) * H;
  if (units == 0) return cudaSuccess;
  Plan p;
  cudaError_t e = make_plan(attn_bwd_kernel<C, KMAX>, hd, Vec<C>::W, sizeof(C),
                            [&](int ld) { return cta_elems<C, KMAX>(K, ld); }, &p);
  if (e != cudaSuccess) return e;
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  attn_bwd_kernel<C, KMAX><<<(units + UPC - 1) / UPC, 32 * kWarps, p.smem, stream>>>(
      (const C*)q, (const C*)k, (const C*)v, (const C*)dout, (C*)dq, (C*)dk, (C*)dv, K, H, hd,
      p.ld, units, vec_ok(hd, Vec<C>::W, ptrs, 7), (C)(1.0 / sqrt((double)hd)));
  return cudaGetLastError();
}

template <typename C>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, int R, int K, int H, int hd, cudaStream_t s) {
  if (K < 1 || K > 64 || hd < 1 || hd > 128) return cudaErrorInvalidValue;
  if (K <= 16) return launch<C, 16>(q, k, v, dout, dq, dk, dv, R, K, H, hd, s);
  if (K <= 32) return launch<C, 32>(q, k, v, dout, dq, dk, dv, R, K, H, hd, s);
  return launch<C, 64>(q, k, v, dout, dq, dk, dv, R, K, H, hd, s);
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
    case kFloat32: return (int)dispatch<float>(q, k, v, dout, dq, dk, dv, R, K, H, hd, s);
    case kFloat64: return (int)dispatch<double>(q, k, v, dout, dq, dk, dv, R, K, H, hd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
