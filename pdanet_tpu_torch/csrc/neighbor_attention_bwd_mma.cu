// Per-centre neighbour attention (backward), bfloat16, on the tensor cores
// of Hopper (sm_90a).
//
// Replaces the TPU kernel pdanet_tpu/ops/pallas/attention.py:
//   _neighbor_attention_flat_bwd (:256) -> _attn_bwd_kernel (:98), for
//   bfloat16.
// float32 and float64 stay on the SIMT kernel of neighbor_attention_bwd.cu:
// float32 on the tensor cores would mean TF32, and the float64 train step
// on the card is held to rounding against the CPU.
//
// Semantics: q, k, v and dO are the flat (R, H*hd) layout of the PDA
// transformer, R = centres * K, the K rows of one centre contiguous; the
// forward is o = softmax(s q k^T) v per centre and head, s = 1/sqrt(hd).
// The softmax is recomputed (nothing is kept from the forward), then
//   dP = dO v^T,  dS = P * (dP - rowsum(dP * P)),
//   dV = P^T dO,  dQ = (s dS) k,  dK = (s dS)^T q.
// bfloat16 is rounded where the TPU kernel rounds it: S is recomputed from
// bf16(bf16(s) q) (:126), P is rounded to bfloat16 for dV (:146), and s dS
// is rounded to bfloat16 for dQ and dK (:158); the row sum of dP * P and
// dS use the float32 P.  All five products accumulate in float32; dq, dk
// and dv are rounded to bfloat16 once.
//
// What bounds it on the H100: bytes.  It reads q, k, v, dO and writes dq,
// dk, dv, 7 * R * H * hd * 2 bytes: 470 MB at SA1 B=4 K 32 (R 131072, H 4,
// hd 64; 0.140 ms at 3.35 TB/s), 235 MB at SA1 K 16 and SA2 K 16, 470 MB
// at SA2 K 32.  Its 10 * K * R * H * hd flops are 10 K / 14 = 23 per byte
// at K 32, far below the ~295 at which the bf16 tensor cores would bound it.
//
// Design.  One warp is one CTA and walks units (centre, head) in a grid-
// stride loop.  16-byte cp.async copies bring the unit's q, k, v and dO
// into shared memory as KP x hd bfloat16 tiles (rows padded by 16 bytes,
// attention_mma.cuh).  Per 16-row query tile: S = bf16(s q) k^T and dP =
// dO v^T on mma.sync.m16n8k16, the softmax and dS in registers, and P and
// s dS written to shared memory as KP x KP bfloat16 tiles.  Then dV = P^T
// dO and dK = (s dS)^T q per 16-row key tile (the transposed A operands by
// ldmatrix.trans of P and s dS), and dQ = (s dS) k per query tile.  Each
// result is staged as bfloat16 in a tile that is no longer read (dV in v,
// dK in dO, dQ in q) and written with 16-byte stores.  The warp owns its
// unit's rows of dq, dk and dv: no atomics, a deterministic result.
// Shared memory per warp: (4 KP (hd + 8) + 2 KP (KP + 8)) * 2 bytes,
// 23.0 KB at K 32 / hd 64, 39.0 KB at K 32 / hd 128, 86.0 KB at K 64 /
// hd 128 (opt-in; one unit, never all H heads of a centre, which would
// take 4 x 86 KB).  The grid holds as many one-warp CTAs as the card keeps
// resident, so each SM has several units at different phases, one
// copying while another computes.
// Why mma.sync and not wgmma: wgmma takes 64-row tiles, and a centre has
// 16 or 32 rows; stacking centres would bring back the TPU kernel's block-
// diagonal masking (:113-115, :142), wasting 50-75 % of the products of a
// kernel that is bound by bytes anyway.
// Shapes: any K <= 64 (padded to KP, the next multiple of 16: pad rows of
// q, k, v and dO are zero, so pad rows and columns of P and dS add nothing,
// and pad rows are not stored) and hd a multiple of 16 up to 128.

#include <cmath>

#include "attention_mma.cuh"

namespace {

using namespace pdanet_mma;

template <int KP, int HD>
struct Bwd {
  using T = Tile<KP, HD>;
  static constexpr int LDP = KP + 8;     // row stride of the P and s dS tiles
  static constexpr int PT = KP * LDP;
  static constexpr size_t SMEM = (4 * T::ELEMS + 2 * PT) * sizeof(bf16);
};

template <int KP, int HD>
__global__ void __launch_bounds__(32)
attn_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, bf16* __restrict__ dq, bf16* __restrict__ dk,
             bf16* __restrict__ dv, int K, int H, int units, float s_q, float s) {
  using T = Tile<KP, HD>;
  using B = Bwd<KP, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + T::ELEMS;
  bf16* vs = ks + T::ELEMS;
  bf16* dos = vs + T::ELEMS;
  bf16* ps = dos + T::ELEMS;  // P, bfloat16, KP x LDP
  bf16* dss = ps + B::PT;     // s dS, bfloat16, KP x LDP
  const int lane = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  const int D = H * HD;

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int c = unit / H;
    const int col0 = (unit - c * H) * HD;
    const size_t row0 = (size_t)c * K;
    load_tile<KP, HD>(qs, q, row0, col0, K, D, lane);
    load_tile<KP, HD>(ks, k, row0, col0, K, D, lane);
    load_tile<KP, HD>(vs, v, row0, col0, K, D, lane);
    load_tile<KP, HD>(dos, dout, row0, col0, K, D, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    // P and s dS, one 16-row query tile at a time
#pragma unroll 1
    for (int mi = 0; mi < KP / 16; ++mi) {
      float p[KP / 8][4], dp[KP / 8][4];
      rows_times_tileT<KP, HD, true>(p, qs, ks, mi * 16, s_q, lane);
      softmax_rows<KP>(p, K, lane);
      rows_times_tileT<KP, HD, false>(dp, dos, vs, mi * 16, 0.f, lane);
      float dot0 = 0.f, dot1 = 0.f;  // rowsum(dP * P) of rows g and g + 8
#pragma unroll
      for (int nt = 0; nt < KP / 8; ++nt) {
        dot0 = __fadd_rn(dot0, __fadd_rn(__fmul_rn(dp[nt][0], p[nt][0]),
                                         __fmul_rn(dp[nt][1], p[nt][1])));
        dot1 = __fadd_rn(dot1, __fadd_rn(__fmul_rn(dp[nt][2], p[nt][2]),
                                         __fmul_rn(dp[nt][3], p[nt][3])));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        dot0 = __fadd_rn(dot0, __shfl_xor_sync(0xffffffffu, dot0, off));
        dot1 = __fadd_rn(dot1, __shfl_xor_sync(0xffffffffu, dot1, off));
      }
      const int r = mi * 16 + g;
#pragma unroll
      for (int nt = 0; nt < KP / 8; ++nt) {
        const int col = nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ps + r * B::LDP + col) = pack_bf16(p[nt][0], p[nt][1]);
        *reinterpret_cast<uint32_t*>(ps + (r + 8) * B::LDP + col) = pack_bf16(p[nt][2], p[nt][3]);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = __fmul_rn(__fmul_rn(p[nt][e], __fsub_rn(dp[nt][e], e < 2 ? dot0 : dot1)), s);
        *reinterpret_cast<uint32_t*>(dss + r * B::LDP + col) = pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(dss + (r + 8) * B::LDP + col) = pack_bf16(ds[2], ds[3]);
      }
    }
    __syncwarp();

    // dV = P^T dO, staged in v (no longer read); dK = (s dS)^T q, staged
    // in dO (no longer read once dV is done)
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const bf16* a_src = pass == 0 ? ps : dss;
      const bf16* b_src = pass == 0 ? dos : qs;
      bf16* stage = pass == 0 ? vs : dos;
      bf16* out = pass == 0 ? dv : dk;
#pragma unroll 1
      for (int mj = 0; mj < KP / 16; ++mj) {
        uint32_t a[KP / 16][4];
#pragma unroll
        for (int kq = 0; kq < KP / 16; ++kq) ldsm_a_trans(a[kq], a_src, B::LDP, mj * 16, kq * 16, lane);
        float acc[HD / 8][4];
        frags_times_tile<KP, HD>(acc, a, b_src, lane);
        stage_rows16<KP, HD>(stage, acc, mj * 16, lane);
        __syncwarp();
        store_rows16<KP, HD>(out, stage, mj * 16, row0, col0, K, D, lane);
      }
      __syncwarp();
    }

    // dQ = (s dS) k, staged in q (no longer read once dK is done)
#pragma unroll 1
    for (int mi = 0; mi < KP / 16; ++mi) {
      uint32_t a[KP / 16][4];
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) ldsm_a(a[kk], dss, B::LDP, mi * 16, kk * 16, lane);
      float acc[HD / 8][4];
      frags_times_tile<KP, HD>(acc, a, ks, lane);
      stage_rows16<KP, HD>(qs, acc, mi * 16, lane);
      __syncwarp();
      store_rows16<KP, HD>(dq, qs, mi * 16, row0, col0, K, D, lane);
    }
    __syncwarp();  // every tile is read before the next unit's copies land
  }
}

template <int KP, int HD>
int* cache_of() {  // resident CTAs per SM of this instantiation, per device
  static int per_device[16];
  return per_device;
}

template <int KP, int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, bf16* dq,
                   bf16* dk, bf16* dv, int R, int K, int H, cudaStream_t stream) {
  const int units = (R / K) * H;
  if (units == 0) return cudaSuccess;
  int per_sm = 0, sms = 0;
  cudaError_t e =
      resident_per_sm(attn_bwd_mma<KP, HD>, Bwd<KP, HD>::SMEM, cache_of<KP, HD>(), &per_sm, &sms);
  if (e != cudaSuccess) return e;
  const int grid = units < per_sm * sms ? units : per_sm * sms;
  const double s = 1.0 / sqrt((double)HD);
  // the TPU kernel scales q by 1/sqrt(hd) as a bfloat16, and dS by it as
  // a float32
  const float s_q = __bfloat162float(__float2bfloat16_rn((float)s));
  attn_bwd_mma<KP, HD><<<grid, 32, Bwd<KP, HD>::SMEM, stream>>>(q, k, v, dout, dq, dk, dv, K, H,
                                                               units, s_q, (float)s);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout (inputs) and dq, dk, dv (outputs): (R, H*hd) bfloat16,
// contiguous and 16-byte aligned, R a multiple of K, K <= 64, hd a
// multiple of 16 up to 128.
extern "C" int pdanet_neighbor_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                                  const void* dout, void* dq, void* dk, void* dv,
                                                  int R, int K, int H, int hd, void* stream) {
  return (int)with_shape(K, hd, cudaErrorInvalidValue, [&](auto kp, auto hdc) {
    return launch<decltype(kp)::value, decltype(hdc)::value>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (bf16*)dq, (bf16*)dk,
        (bf16*)dv, R, K, H, (cudaStream_t)stream);
  });
}

// One-warp CTAs of the kernel for (K, hd) resident per SM, or -1.
extern "C" int pdanet_neighbor_attention_bwd_bf16_occupancy(int K, int hd) {
  return with_shape(K, hd, -1, [&](auto kp, auto hdc) {
    constexpr int KP = decltype(kp)::value, HD = decltype(hdc)::value;
    int per_sm = 0, sms = 0;
    cudaError_t e = resident_per_sm(attn_bwd_mma<KP, HD>, Bwd<KP, HD>::SMEM, cache_of<KP, HD>(),
                                    &per_sm, &sms);
    return e == cudaSuccess ? per_sm : -1;
  });
}
