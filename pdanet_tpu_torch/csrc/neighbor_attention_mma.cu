// Per-centre neighbour attention (forward), bfloat16, on the tensor cores
// of Hopper (sm_90a).
//
// Replaces the TPU kernel pdanet_tpu/ops/pallas/attention.py:
//   neighbor_attention_flat (:201) -> _attn_kernel (:58), for bfloat16.
// float32 and float64 stay on the SIMT kernel of neighbor_attention.cu:
// float32 on the tensor cores would mean TF32, and the float32 frame and
// the float64 train step are held index for index and to rounding against
// the CPU.
//
// Semantics: q, k, v and o are the flat (R, H*hd) layout of the PDA
// transformer, R = centres * K, the K rows of one centre contiguous.  Per
// centre and head: o = softmax(q k^T / sqrt(hd)) v over the centre's K
// tokens, no mask.  bfloat16 is rounded where the TPU kernel rounds it:
// q is multiplied by bf16(1/sqrt(hd)) and rounded to bfloat16 before the
// product (:74; exact at hd 16 and 64), and the normalised probabilities P
// are rounded to bfloat16 before P v (:92).  Scores, the softmax and both
// products' sums are float32; o is rounded to bfloat16 once.
//
// What bounds it on the H100: bytes.  It reads q, k, v and writes o, 4 * R
// * H * hd * 2 bytes: 67 MB at SA1 b1 (R 32768, K 32, H 4, hd 64; 0.020 ms
// at 3.35 TB/s), 34 MB at SA1 K 16 and SA2 K 16 / 67 MB at SA2 K 32 (R
// 16384 / 32768 rows of 512).  Its 4 * K * R * H * hd flops are K / 2 = 16
// per byte at K 32, against the ~295 at which the bf16 tensor cores would
// start to bound it.
//
// Design.  One warp is one CTA and walks units (centre, head) in a grid-
// stride loop, with two shared-memory stages: while it computes one unit,
// 16-byte cp.async copies bring the next unit's q, k and v (K rows of hd *
// 2 contiguous bytes each) into the other stage as bfloat16 tiles (see
// attention_mma.cuh for the padding that keeps ldmatrix free of bank
// conflicts).  Per 16-row tile of the unit: S = bf16(s q) k^T on
// mma.sync.m16n8k16 (A and B by ldmatrix), the row softmax on the S
// accumulators in registers (row max and sum over the quad of lanes that
// holds a row, __shfl_xor_sync 1 and 2; pad columns -inf), P rounded to
// bfloat16 and fed straight into the A operand of O = P v (v by
// ldmatrix.trans), and O staged as bfloat16 in the q rows it replaces and
// written with 16-byte stores.  The grid holds as many one-warp CTAs as
// the card keeps resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// so every SM has several units' copies in flight.  Shared memory per warp:
// 2 * 3 * KP * (hd + 8) * 2 bytes, 27.0 KB at K 32 / hd 64, 51.0 KB at K 32
// / hd 128, 102 KB at K 64 / hd 128 (opt-in).
// Why mma.sync and not wgmma: wgmma takes 64-row tiles, and a centre has
// 16 or 32 rows.  Stacking centres into 64 rows would bring back the TPU
// kernel's block-diagonal masking (:62-64, :87), which wastes 50-75 % of
// the products -- and the kernel is bound by bytes, not by the tensor
// cores' rate.
// Shapes: any K <= 64 (padded to KP, the next multiple of 16: pad rows are
// zero and not stored, pad score columns are -inf before the max) and hd
// a multiple of 16 up to 128; the wrapper raises for anything else.

#include <cmath>

#include "attention_mma.cuh"

namespace {

using namespace pdanet_mma;

template <int KP, int HD>
struct Fwd {
  using T = Tile<KP, HD>;
  static constexpr int STAGE = 3 * T::ELEMS;  // q, k, v
  static constexpr size_t SMEM = 2 * STAGE * sizeof(bf16);
};

template <int KP, int HD>
__device__ __forceinline__ void load_unit(bf16* st, const bf16* q, const bf16* k, const bf16* v,
                                          int unit, int K, int H, int lane) {
  using T = Tile<KP, HD>;
  const int c = unit / H;
  const int col0 = (unit - c * H) * HD;
  const size_t row0 = (size_t)c * K;
  load_tile<KP, HD>(st, q, row0, col0, K, H * HD, lane);
  load_tile<KP, HD>(st + T::ELEMS, k, row0, col0, K, H * HD, lane);
  load_tile<KP, HD>(st + 2 * T::ELEMS, v, row0, col0, K, H * HD, lane);
}

template <int KP, int HD>
__global__ void __launch_bounds__(32)
attn_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, int K, int H, int units, float s) {
  using T = Tile<KP, HD>;
  using F = Fwd<KP, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int lane = threadIdx.x;
  const int D = H * HD;
  int unit = blockIdx.x;
  if (unit >= units) return;
  load_unit<KP, HD>(sm, q, k, v, unit, K, H, lane);
  cp_async_commit();

  for (int stage = 0; unit < units; unit += gridDim.x, stage ^= 1) {
    const int next = unit + gridDim.x;
    if (next < units) load_unit<KP, HD>(sm + (stage ^ 1) * F::STAGE, q, k, v, next, K, H, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this unit's copies have landed (the next may be in flight)
    __syncwarp();
    bf16* qs = sm + stage * F::STAGE;
    const bf16* ks = qs + T::ELEMS;
    const bf16* vs = ks + T::ELEMS;
    const int c = unit / H;
    const int col0 = (unit - c * H) * HD;
    const size_t row0 = (size_t)c * K;

#pragma unroll 1
    for (int mi = 0; mi < KP / 16; ++mi) {
      float sc[KP / 8][4];
      rows_times_tileT<KP, HD, true>(sc, qs, ks, mi * 16, s, lane);

      softmax_rows<KP>(sc, K, lane);
      uint32_t pa[KP / 16][4];  // P rounded to bfloat16: two C tiles make one A tile
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) c_to_a(pa[kk], sc[2 * kk], sc[2 * kk + 1]);

      float acc[HD / 8][4];
      frags_times_tile<KP, HD>(acc, pa, vs, lane);

      __syncwarp();  // every lane has read this tile's q rows
      stage_rows16<KP, HD>(qs, acc, mi * 16, lane);
      __syncwarp();
      store_rows16<KP, HD>(o, qs, mi * 16, row0, col0, K, D, lane);
    }
    __syncwarp();  // this stage is refilled for the unit after next
  }
}

template <int KP, int HD>
int* cache_of() {  // resident CTAs per SM of this instantiation, per device
  static int per_device[16];
  return per_device;
}

template <int KP, int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int R, int K, int H,
                   cudaStream_t stream) {
  const int units = (R / K) * H;
  if (units == 0) return cudaSuccess;
  int per_sm = 0, sms = 0;
  cudaError_t e = resident_per_sm(attn_fwd_mma<KP, HD>, Fwd<KP, HD>::SMEM,
                                  cache_of<KP, HD>(), &per_sm, &sms);
  if (e != cudaSuccess) return e;
  const int grid = units < per_sm * sms ? units : per_sm * sms;
  // the TPU kernel's scale: 1/sqrt(hd) as a bfloat16
  const float s = __bfloat162float(__float2bfloat16_rn((float)(1.0 / sqrt((double)(HD)))));
  attn_fwd_mma<KP, HD><<<grid, 32, Fwd<KP, HD>::SMEM, stream>>>(q, k, v, o, K, H, units, s);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (R, H*hd) bfloat16, contiguous and 16-byte aligned, R a
// multiple of K, K <= 64, hd a multiple of 16 up to 128.
extern "C" int pdanet_neighbor_attention_bf16(const void* q, const void* k, const void* v,
                                              void* o, int R, int K, int H, int hd,
                                              void* stream) {
  return (int)with_shape(K, hd, cudaErrorInvalidValue, [&](auto kp, auto hdc) {
    return launch<decltype(kp)::value, decltype(hdc)::value>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, R, K, H,
        (cudaStream_t)stream);
  });
}

// One-warp CTAs of the kernel for (K, hd) resident per SM, or -1.
extern "C" int pdanet_neighbor_attention_bf16_occupancy(int K, int hd) {
  return with_shape(K, hd, -1, [&](auto kp, auto hdc) {
    constexpr int KP = decltype(kp)::value, HD = decltype(hdc)::value;
    int per_sm = 0, sms = 0;
    cudaError_t e = resident_per_sm(attn_fwd_mma<KP, HD>, Fwd<KP, HD>::SMEM,
                                    cache_of<KP, HD>(), &per_sm,
                                    &sms);
    return e == cudaSuccess ? per_sm : -1;
  });
}
