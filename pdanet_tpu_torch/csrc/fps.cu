// Distance farthest-point sampling (D-FPS) for Hopper (sm_90a).
//
// Replaces the TPU kernels pdanet_tpu/ops/pallas/fps.py:
//   farthest_point_sample_pallas (:365) -> _fps_kernel (:63), _fps_kernel_v2 (:126)
//   farthest_point_sample_pallas_grouped (:317) -> _fps_kernel_grouped (:173)
// One thread-block cluster per frame covers all three: frames run on
// separate clusters side by side, so the TPU's frame grouping (latency
// hiding inside one program) has no counterpart.
//
// Semantics (held exactly against _farthest_point_sample_xla,
// pdanet_tpu/ops/sampling.py:62-83): the first index is 0, the running
// min-distance starts at 1e10, each step takes the argmax with the lowest
// index on ties.  The distance is dx*dx + dy*dy + dz*dz evaluated left to
// right with round-to-nearest intrinsics, so no FMA contraction can change
// a tie and with it an index.
//
// What bounds it on the H100: the npoint-step dependency chain, not bytes
// or operations.  Each step is a distance update, an argmax over the whole
// frame and a broadcast of the winner.  One 1024-thread CTA per frame (the
// previous design) spent ~2.1 us a step: 48K shared-memory loads for the
// coordinates, a two-barrier block argmax and a re-read of the winner, on
// one SM of 132.
// Design: a cluster of C CTAs per frame (8 CTAs of 128 threads for KITTI's
// 16384 points, up to the non-portable 16 for larger clouds; config), each
// CTA owning one contiguous slice of the cloud.  Each thread keeps its P
// points' x, y, z and running min-distance in registers (4 registers a
// point), so the update reads no memory.  The argmax runs as a total
// order on (t, -index): t >= 0, so its float bits order like t, and the
// winner is the largest t, then the lowest index.  A warp reduces with two redux instructions (max of the t
// bits, then min of the index among lanes holding that max) and fetches
// the winner's coordinates with three shuffles (each thread carries its
// best point's coordinates, so nothing is looked up by index).  Lanes
// 0..C-1 then send the warp's record (t, index, x, y, z) to every CTA of
// the cluster with st.async, which counts its bytes on the destination's
// mbarrier: one exchange through distributed shared memory, and one
// barrier wait per step, on the CTA's own mbarrier.  Every warp reduces
// the C*W records of its CTA's table the same way and so holds the winner
// and its coordinates (the TPU's _fps_kernel_v2 idea: the winner's
// coordinates are carried forward, not re-read).  Tables and mbarriers are
// double-buffered by step parity: records of step j + 2 reach slot j & 1
// only after every warp of the cluster sent its step j + 1 record, which
// it does after its reads of step j, so no second barrier resets them.
// Exact chunk skip (FlashFPS / FuseFPS, PAPERS.md): a warp skips its
// distance update when the squared distance from the new centre to its
// points' bounding box is at or above its largest running distance; see
// box_lower_bound (distance.cuh) for why that leaves every t bit for bit
// unchanged.  It is a warp-uniform branch here (on the TPU it lost to VPU
// predication), on by default where a thread holds 32 points (ONCE's
// 60000) or the cloud is in global memory.  Clouds beyond the registers (more than
// 16 * 256 * 32 = 131072 points) run the same kernel with the points and
// the running distance in global memory (P = 0, the `temp` scratch row).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "distance.cuh"

namespace {

using pdanet_dist::box_lower_bound;
using pdanet_dist::dist2;

constexpr int kMaxCluster = 16;
constexpr int kPMax = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // index of an empty warp's record

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t mapa(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// Remote stores that count their bytes on the destination's mbarrier.
__device__ __forceinline__ void st_async(uint32_t remote, uint4 v, uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(remote), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar) : "memory");
}
__device__ __forceinline__ void st_async(uint32_t remote, uint32_t v, uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(remote), "r"(v), "r"(remote_bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// T threads per CTA (kWarps warps); P points per thread in registers, or
// P == 0 for the points in global memory (xyz_soa) and the running
// distance in temp_g, `ppt` points per thread.  Grid (C, B), cluster
// (C, 1, 1): cluster b is frame b, its CTA r owns points
// [r * T * ppt, (r + 1) * T * ppt).  Warp w of CTA r owns the 32 * ppt
// points from (r * kWarps + w) * 32 * ppt on; its lane l the points
// base + k * 32 + l, ascending in k.
template <int T, int P>
__global__ void __launch_bounds__(T, 1)
fps_kernel(const float* __restrict__ xyz_soa, int N, int npoint, int ppt_runtime, int skip,
           float* __restrict__ temp_g, int32_t* __restrict__ out) {
  constexpr int kWarps = T / 32;
  constexpr int kMaxRecords = kMaxCluster * kWarps;
  constexpr int PR = P > 0 ? P : 1;
  __shared__ uint4 rec[2][kMaxRecords];       // (t bits, index, x, y) per warp of the cluster
  __shared__ uint32_t rec_z[2][kMaxRecords];  // z
  __shared__ uint64_t bar[2];                 // the records of step j land on bar[j & 1]

  const int C = (int)gridDim.x;
  const uint32_t rank = cluster_rank();
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ppt = P > 0 ? P : ppt_runtime;
  const int wbase = (int)(rank * kWarps + warp) * 32 * ppt;
  const int rem = N - wbase - lane;
  const int kv = rem <= 0 ? 0 : min(ppt, (rem + 31) / 32);  // this lane's valid points
  const float* xs = xyz_soa + (size_t)b * 3 * N;
  const float* ys = xs + N;
  const float* zs = ys + N;
  float* temp = P > 0 ? nullptr : temp_g + (size_t)b * N;

  float px[PR], py[PR], pz[PR], t[PR];
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  auto grow = [&](float x, float y, float z) {
    lo[0] = fminf(lo[0], x); lo[1] = fminf(lo[1], y); lo[2] = fminf(lo[2], z);
    hi[0] = fmaxf(hi[0], x); hi[1] = fmaxf(hi[1], y); hi[2] = fmaxf(hi[2], z);
  };
  if constexpr (P > 0) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = wbase + k * 32 + lane;
      px[k] = py[k] = pz[k] = 0.f;
      t[k] = 1e10f;
      if (k < kv) {
        px[k] = xs[i];
        py[k] = ys[i];
        pz[k] = zs[i];
        grow(px[k], py[k], pz[k]);
      }
    }
  } else {
    for (int k = 0; k < kv; ++k) {
      const int i = wbase + k * 32 + lane;
      temp[i] = 1e10f;
      grow(xs[i], ys[i], zs[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], off));
    }
  }

  // the warp's record while its t are all 1e10: its lowest index wins
  const bool warp_empty = __shfl_sync(kFull, kv, 0) == 0;
  uint32_t w_t = warp_empty ? 0u : __float_as_uint(1e10f);
  uint32_t w_i = warp_empty ? kNone : (uint32_t)wbase;
  float w_x = __shfl_sync(kFull, P > 0 ? px[0] : (kv ? xs[wbase + lane] : 0.f), 0);
  float w_y = __shfl_sync(kFull, P > 0 ? py[0] : (kv ? ys[wbase + lane] : 0.f), 0);
  float w_z = __shfl_sync(kFull, P > 0 ? pz[0] : (kv ? zs[wbase + lane] : 0.f), 0);

  float cx = xs[0], cy = ys[0], cz = zs[0];
  int32_t* o = out + (size_t)b * npoint;
  if (rank == 0 && threadIdx.x == 0) o[0] = 0;
  const int n_rec = C * kWarps;
  const int my_rec = (int)rank * kWarps + warp;
  // Lane l < C sends the record's (t, index, x, y) to CTA l, lane 16 + l its z.
  const uint32_t dst = (uint32_t)(lane & 15);
  const bool sends_xy = lane < C, sends_z = lane >= 16 && lane - 16 < C;
  uint32_t r_rec[2], r_z[2], r_bar[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    r_rec[s] = mapa(smem_addr(&rec[s][my_rec]), dst);
    r_z[s] = mapa(smem_addr(&rec_z[s][my_rec]), dst);
    r_bar[s] = mapa(smem_addr(&bar[s]), dst);
  }
  // One thread arms each barrier with the bytes of its step's records, for
  // steps 1 and 2 here and for step j + 2 right after step j's records
  // have landed.  Bytes that land before the arming leave the phase
  // pending: it completes only after the arming thread's arrival.
  const bool arms = threadIdx.x == 0;
  const uint32_t tx_bytes = (uint32_t)n_rec * 20u;
  if (arms) {
    mbar_init(smem_addr(&bar[0]), 1);
    mbar_init(smem_addr(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(smem_addr(&bar[0]), tx_bytes);
    mbar_expect_tx(smem_addr(&bar[1]), tx_bytes);
  }
  // a record's owner from its point index: index >> shift (P > 0: spans are
  // powers of two), else index / span
  const uint32_t span = (uint32_t)(32 * ppt);
  const int shift = __ffs((int)span) - 1;
  // every CTA of the cluster runs, with its barriers initialised, before
  // any remote store
  cluster_barrier();

  for (int j = 1; j < npoint; ++j) {
    const int slot = j & 1;
    const bool skip_warp =
        skip && box_lower_bound(lo[0], lo[1], lo[2], hi[0], hi[1], hi[2], cx, cy, cz) >=
                    __uint_as_float(w_t);
    if (!skip_warp) {  // warp-uniform
      float bt, bx, by, bz;
      uint32_t bi;
      if constexpr (P > 0) {
        // update, then the thread's argmax as a tree over adjacent groups
        // of its points (the right group wins only on a strictly larger t,
        // so the lowest index wins ties); invalid points carry t = -1
        float ct[P], cxs[P], cys[P], czs[P];
        int ck[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          t[k] = fminf(t[k], dist2(px[k], py[k], pz[k], cx, cy, cz));
          ct[k] = k < kv ? t[k] : -1.f;
          ck[k] = k;
          cxs[k] = px[k];
          cys[k] = py[k];
          czs[k] = pz[k];
        }
#pragma unroll
        for (int h = 1; h < P; h *= 2) {
#pragma unroll
          for (int k = 0; k + h < P; k += 2 * h) {
            const bool right = ct[k + h] > ct[k];
            ct[k] = right ? ct[k + h] : ct[k];
            ck[k] = right ? ck[k + h] : ck[k];
            cxs[k] = right ? cxs[k + h] : cxs[k];
            cys[k] = right ? cys[k + h] : cys[k];
            czs[k] = right ? czs[k + h] : czs[k];
          }
        }
        const bool any = ct[0] >= 0.f;
        bt = any ? ct[0] : 0.f;
        bi = any ? (uint32_t)(wbase + ck[0] * 32 + lane) : kNone;
        bx = cxs[0];
        by = cys[0];
        bz = czs[0];
      } else {
        bt = 0.f;
        bx = by = bz = 0.f;
        bi = kNone;
        for (int k = 0; k < kv; ++k) {
          const int i = wbase + k * 32 + lane;
          const float x = xs[i], y = ys[i], z = zs[i];
          const float tk = fminf(temp[i], dist2(x, y, z, cx, cy, cz));
          temp[i] = tk;
          if (tk > bt || bi == kNone) {
            bt = tk;
            bi = (uint32_t)i;
            bx = x;
            by = y;
            bz = z;
          }
        }
      }
      // the warp's winner: the largest t, then the lowest index; its lane
      // is w_i & 31 (wbase is a multiple of 32; lane 31 of an empty warp,
      // whose record never wins)
      const uint32_t tb = __float_as_uint(bt);
      w_t = __reduce_max_sync(kFull, tb);
      w_i = __reduce_min_sync(kFull, tb == w_t ? bi : kNone);
      const int src = (int)(w_i & 31u);
      w_x = __shfl_sync(kFull, bx, src);
      w_y = __shfl_sync(kFull, by, src);
      w_z = __shfl_sync(kFull, bz, src);
    }
    if (sends_xy)
      st_async(r_rec[slot], make_uint4(w_t, w_i, __float_as_uint(w_x), __float_as_uint(w_y)),
               r_bar[slot]);
    if (sends_z) st_async(r_z[slot], __float_as_uint(w_z), r_bar[slot]);
    const uint32_t my_bar = smem_addr(&bar[slot]);
    mbar_wait(my_bar, (uint32_t)((j - 1) >> 1) & 1u);
    if (arms && j + 2 < npoint) mbar_expect_tx(my_bar, tx_bytes);

    // this lane's records q = lane + 32 u, loaded side by side, then a tree
    // (a later record wins only on a larger t or an equal t and a lower
    // index)
    constexpr int kPerLane = kMaxRecords / 32;
    uint32_t qt[kPerLane], qi[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      qt[u] = 0;
      qi[u] = kNone;
      if (lane + 32 * u < n_rec) {
        const uint2 r = *reinterpret_cast<const uint2*>(&rec[slot][lane + 32 * u]);
        qt[u] = r.x;
        qi[u] = r.y;
      }
    }
#pragma unroll
    for (int h = 1; h < kPerLane; h *= 2) {
#pragma unroll
      for (int u = 0; u + h < kPerLane; u += 2 * h) {
        const bool right = qt[u + h] > qt[u] || (qt[u + h] == qt[u] && qi[u + h] < qi[u]);
        qt[u] = right ? qt[u + h] : qt[u];
        qi[u] = right ? qi[u + h] : qi[u];
      }
    }
    const uint32_t m = __reduce_max_sync(kFull, qt[0]);
    const uint32_t ri = __reduce_min_sync(kFull, qt[0] == m ? qi[0] : kNone);
    // the winner's coordinates from the record that carried it
    const int owner = (int)(P > 0 ? ri >> shift : ri / span);
    const uint4 w = rec[slot][owner];
    cx = __uint_as_float(w.z);
    cy = __uint_as_float(w.w);
    cz = __uint_as_float(rec_z[slot][owner]);
    if (rank == 0 && threadIdx.x == 0) o[j] = (int32_t)ri;
  }
  // no CTA leaves while a record bound for it may be in flight
  cluster_barrier();
}

// A sweep build (chip_smoke.py --sweep) compiles this file with
// -DPDANET_FPS_CLUSTER=C -DPDANET_FPS_THREADS=T -DPDANET_FPS_SKIP=S to time
// one forced launch shape.  The library the port loads takes the shape
// from N alone.
#ifdef PDANET_FPS_CLUSTER
constexpr int kForce[3] = {PDANET_FPS_CLUSTER, PDANET_FPS_THREADS, PDANET_FPS_SKIP};
constexpr bool kForced = true;
#else
constexpr int kForce[3] = {0, 0, 0};
constexpr bool kForced = false;
#endif

// The launch shape for N points (chip_smoke.py --sweep on the H100): 128
// threads a CTA up to 16 * 128 * 32 = 65536 points, else 256; the smallest
// cluster that holds the cloud at <= 16 points a thread (16384 points: 8
// CTAs), else 16 CTAs; the points per thread as a power of two, or 0
// beyond kPMax (global memory); the chunk skip where a thread holds 32
// points or the cloud is in global memory (it lost at 16 points a thread,
// won at 32).  So 128 threads come with 1-32 points a thread and 256 with
// 32 or 0.
void config(int N, int* C, int* T, int* P, int* S) {
  const int t = kForced ? kForce[1]
                        : ((long long)N <= (long long)kMaxCluster * 128 * kPMax ? 128 : 256);
  int c = kForced ? kForce[0] : 1;
  while (!kForced && c < kMaxCluster && (long long)c * t * 16 < N) c *= 2;
  const long long need = ((long long)N + (long long)c * t - 1) / ((long long)c * t);
  int p = 0;
  for (int q = 1; q <= kPMax; q *= 2) {
    if (need <= q) {
      p = q;
      break;
    }
  }
  *C = c;
  *T = t;
  *P = p;
  *S = kForced ? kForce[2] : (p == 0 || p == kPMax);
}

template <int T, int P>
cudaError_t launch(const float* xyz_soa, int B, int N, int npoint, int C, int ppt, int skip,
                   float* temp, int32_t* out, cudaStream_t stream) {
  auto kernel = fps_kernel<T, P>;
  if (C > 8) {  // 16 is above the portable cluster size
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, xyz_soa, N, npoint, ppt, skip, temp, out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The instantiations config can pick (a sweep build has them all).
template <int T>
cudaError_t launch_t(const float* xyz_soa, int B, int N, int npoint, int C, int P, int skip,
                     float* temp, int32_t* out, cudaStream_t s) {
  constexpr bool few = T == 128 || kForced;     // 1-16 points a thread
  constexpr bool global = T == 256 || kForced;  // points in global memory
  switch (P) {
    case 1:
      if constexpr (few) return launch<T, 1>(xyz_soa, B, N, npoint, C, 1, skip, temp, out, s);
      break;
    case 2:
      if constexpr (few) return launch<T, 2>(xyz_soa, B, N, npoint, C, 2, skip, temp, out, s);
      break;
    case 4:
      if constexpr (few) return launch<T, 4>(xyz_soa, B, N, npoint, C, 4, skip, temp, out, s);
      break;
    case 8:
      if constexpr (few) return launch<T, 8>(xyz_soa, B, N, npoint, C, 8, skip, temp, out, s);
      break;
    case 16:
      if constexpr (few) return launch<T, 16>(xyz_soa, B, N, npoint, C, 16, skip, temp, out, s);
      break;
    case 32: return launch<T, 32>(xyz_soa, B, N, npoint, C, 32, skip, temp, out, s);
    default:
      if constexpr (global) {
        const int ppt = (int)(((long long)N + (long long)C * T - 1) / ((long long)C * T));
        return launch<T, 0>(xyz_soa, B, N, npoint, C, ppt, skip, temp, out, s);
      }
  }
  return cudaErrorInvalidConfiguration;
}

}  // namespace

// The launch shape for N points: cfg[0] cluster size, cfg[1] threads per
// CTA, cfg[2] points per thread in registers (0: points and running
// distance in global memory, which needs the temp row), cfg[3] 1 for the
// chunk skip.
extern "C" int pdanet_fps_config(int N, int* cfg) {
  config(N, &cfg[0], &cfg[1], &cfg[2], &cfg[3]);
  return 0;
}

// xyz_soa: (B, 3, N) float32 contiguous; out: (B, npoint) int32; temp:
// (B, N) float32 scratch when pdanet_fps_config gives 0 points per
// thread, else unused (may be null).
extern "C" int pdanet_fps(const float* xyz_soa, int B, int N, int npoint, float* temp,
                          int32_t* out, void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  int C, T, P, S;
  config(N, &C, &T, &P, &S);
  if (P == 0 && temp == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (T == 128) return (int)launch_t<128>(xyz_soa, B, N, npoint, C, P, S, temp, out, s);
  if (T == 256) return (int)launch_t<256>(xyz_soa, B, N, npoint, C, P, S, temp, out, s);
  return (int)cudaErrorInvalidConfiguration;
}
