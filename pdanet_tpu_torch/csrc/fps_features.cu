// Feature-space farthest-point sampling (F-FPS) for Hopper (sm_90a).
//
// The JAX package runs F-FPS in XLA (pdanet_tpu/ops/sampling.py:108-137,
// farthest_point_sample_features): no TPU kernel stands behind it.  It is a
// kernel here because it is a serial loop of npoint steps, each a distance
// row over every point, an argmax and a broadcast of the winner's row; a
// plain PyTorch loop costs several launches a step.
//
// Semantics (held exactly against farthest_point_sample_features_plain,
// ops/sampling.py): the first index is 0, the running min-distance starts at
// 1e10, each step takes the argmax with the lowest index on ties.  The
// distance of row i to the last pick is the sum over the channels, in
// channel order, of (f_ic - f_jc)^2, every operation rounded to nearest
// (__fsub_rn, __fmul_rn, __fadd_rn; the library builds with --fmad=false),
// as the plain version adds its squares channel by channel, so both pick
// the same indices.
//
// Design: a thread-block cluster of C CTAs per frame (grid (C, B), cluster
// (C, 1, 1)); CTA r owns the rows [r * R, (r + 1) * R), R = ceil(N / C),
// staged in its shared memory once (row stride C | 1 words, odd, so the 32
// rows a warp reads at one channel sit in 32 banks) with their running
// distances.  A step: every thread updates its rows against the last pick's
// row (kept in shared memory as `cur`) and keeps its best (t, index); the
// CTA reduces to one record (warp shuffles, then warp 0); each CTA writes
// its record into its own shared memory, double-buffered by step parity;
// one cluster barrier; every warp reads the C records through distributed
// shared memory and takes the winner (the largest t, then the lowest
// index); the threads c < channels copy the winner's row from its owner's
// shared memory into `cur`.  A record of step j + 1 overwrites slot
// (j + 1) & 1 only after the barrier of step j, which every CTA reaches
// after its reads of step j - 1's records, so one barrier a step suffices.
// Rows that do not fit in shared memory (more than kSmemMax bytes a CTA
// at 16 CTAs) are read from global memory and the running distance kept in
// the `temp` scratch row: the same kernel with `staged` 0.
//
// What bounds it: the npoint-step dependency chain (a cluster barrier and
// two block barriers a step), not bytes or operations.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kSmemMax = 200 * 1024;  // dynamic shared memory a CTA may take
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float t, int i, float bt, int bi) {
  return t > bt || (t == bt && i < bi);
}

__device__ __forceinline__ void warp_best(float& t, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(kFull, t, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(ot, oi, t, i)) {
      t = ot;
      i = oi;
    }
  }
}

// feats: (B, N, C) float32; out: (B, npoint) int32; temp: (B, N) float32
// when the rows are not staged.  Dynamic shared memory when staged: R rows
// of `stride` words, then R running distances; always the last pick's row.
__global__ void __launch_bounds__(kThreads, 1)
fps_features_kernel(const float* __restrict__ feats, int N, int C, int npoint, int staged,
                    float* __restrict__ temp_g, int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float rec_t[2];
  __shared__ int rec_i[2];
  __shared__ float wbuf_t[kWarps];
  __shared__ int wbuf_i[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = (N + n_cta - 1) / n_cta;
  const int row0 = rank * R;
  const int n_own = max(0, min(R, N - row0));
  const int stride = staged ? (C | 1) : C;
  const float* frame = feats + (size_t)b * N * C;

  float* rows = staged ? smem : const_cast<float*>(frame + (size_t)row0 * C);
  float* t = staged ? smem + (size_t)R * stride : temp_g + (size_t)b * N + row0;
  float* cur = staged ? smem + (size_t)R * (stride + 1) : smem;

  if (staged) {
    for (int e = tid; e < n_own * C; e += kThreads) {
      const int i = e / C, c = e - i * C;
      rows[i * stride + c] = frame[(size_t)(row0 + i) * C + c];
    }
  }
  for (int i = tid; i < n_own; i += kThreads) t[i] = 1e10f;
  for (int c = tid; c < C; c += kThreads) cur[c] = frame[c];
  int32_t* o = out + (size_t)b * npoint;
  if (rank == 0 && tid == 0) o[0] = 0;
  // every CTA's rows are staged before any is read remotely
  cluster.sync();

  for (int j = 1; j < npoint; ++j) {
    const int slot = j & 1;
    float bt = -1.f;
    int bi = 0x7fffffff;
    for (int i = tid; i < n_own; i += kThreads) {
      const float* r = rows + (size_t)i * stride;
      float d = 0.f;
      for (int c = 0; c < C; ++c) {
        const float diff = __fsub_rn(r[c], cur[c]);
        d = __fadd_rn(d, __fmul_rn(diff, diff));
      }
      const float ti = fminf(t[i], d);
      t[i] = ti;
      if (ti > bt) {  // ascending rows: the first maximum stays
        bt = ti;
        bi = row0 + i;
      }
    }
    warp_best(bt, bi);
    if (lane == 0) {
      wbuf_t[warp] = bt;
      wbuf_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      float wt = lane < kWarps ? wbuf_t[lane] : -1.f;
      int wi = lane < kWarps ? wbuf_i[lane] : 0x7fffffff;
      warp_best(wt, wi);
      if (lane == 0) {
        rec_t[slot] = wt;
        rec_i[slot] = wi;
      }
    }
    cluster.sync();
    // every warp takes the winner from the cluster's records
    float wt = -1.f;
    int wi = 0x7fffffff;
    if (lane < n_cta) {
      wt = cluster.map_shared_rank(&rec_t[slot], lane)[0];
      wi = cluster.map_shared_rank(&rec_i[slot], lane)[0];
    }
    warp_best(wt, wi);
    if (rank == 0 && tid == 0) o[j] = wi;
    const int owner = wi / R;
    const int local = wi - owner * R;
    if (tid < C) {
      const float* src = staged ? cluster.map_shared_rank(rows, owner) + (size_t)local * stride
                                : frame + (size_t)wi * C;
      cur[tid] = src[tid];
    }
    for (int c = kThreads + tid; c < C; c += kThreads) {
      const float* src = staged ? cluster.map_shared_rank(rows, owner) + (size_t)local * stride
                                : frame + (size_t)wi * C;
      cur[c] = src[c];
    }
    __syncthreads();
  }
  // no CTA leaves while its rows or records may still be read
  cluster.sync();
}

// The launch shape for N rows of C channels: the smallest cluster (a power
// of two up to 16) whose CTAs hold at most two rows a thread in shared
// memory; else 16 CTAs, staged if their rows fit, else read from global
// memory.
void config(int N, int C, int* cl, int* staged, int* smem) {
  const long long stride = C | 1;
  for (int c = 1; c <= kMaxCluster; c *= 2) {
    const long long R = ((long long)N + c - 1) / c;
    const long long bytes = (R * (stride + 1) + C) * 4;
    if ((R <= 2 * kThreads && bytes <= kSmemMax) || c == kMaxCluster) {
      *cl = c;
      *staged = bytes <= kSmemMax;
      *smem = *staged ? (int)bytes : C * 4;
      return;
    }
  }
}

}  // namespace

// cfg[0] cluster size, cfg[1] threads per CTA, cfg[2] 1 if the rows are
// staged in shared memory (else the temp row is needed), cfg[3] bytes of
// dynamic shared memory.
extern "C" int pdanet_fps_features_config(int N, int C, int* cfg) {
  config(N, C, &cfg[0], &cfg[2], &cfg[3]);
  cfg[1] = kThreads;
  return 0;
}

// feats: (B, N, C) float32 contiguous; out: (B, npoint) int32; temp: (B, N)
// float32 scratch when pdanet_fps_features_config gives 0 (unstaged), else
// unused (may be null).
extern "C" int pdanet_fps_features(const float* feats, int B, int N, int C, int npoint,
                                   float* temp, int32_t* out, void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  int cl, staged, smem;
  config(N, C, &cl, &staged, &smem);
  if (!staged && temp == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fps_features_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e != cudaSuccess) return (int)e;
  if (cl > 8) {  // 16 is above the portable cluster size
    e = cudaFuncSetAttribute(fps_features_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fps_features_kernel, feats, N, C, npoint, staged, temp, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
