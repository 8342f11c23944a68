// Rotated BEV self-IoU (the NMS suppression matrix) for Hopper (sm_90a).
//
// Replaces the TPU kernel pdanet_tpu/ops/pallas/rotated_iou.py:
//   boxes_iou_bev_self_pallas (:244) -> _iou_tile_kernel (:95)
//
// Semantics: the XLA formulation of pdanet_tpu/ops/rotated_iou.py:47-296
// with self_pair=True, which is what the CPU tests compare against -- not
// the reference CUDA.  Per pair: 16 edge-pair intersections (i-major,
// j-minor) with the relative-determinant guard and the on-segment check,
// then per corner k "b_k inside a" and "a_k inside b" with the 1e-2 margin;
// centroid of the valid candidates, stable angular sort, triangle fan from
// the first vertex, and the overlap clamped to min(area_a, area_b) so that
// IoU <= 1.  The file is compiled with --fmad=false: every a*b - c*d is two
// rounded products, so coincident edges give exact zero cross products and
// the diagonal (a box with itself) gives IoU 1.  atan2 and a stable
// insertion sort replace the TPU kernel's pseudo-angle and Batcher network
// (pdanet_tpu/ops/pallas/rotated_iou.py:12-22), which were Mosaic
// workarounds.  The full (B, K, K) matrix is computed, both triangles and
// the diagonal: IoU is not assumed symmetric in float.
//
// What bounds it on the H100: arithmetic on the few pairs that can
// overlap (~1.5k flops and up to 24 candidate vertices each), and the
// divergence of warps in which only some lanes clip.  Design: one CTA of
// 256 threads per 16 x 16 tile of (i, j):
// - Per-box records: the CTA's 32 boxes (i-tile and j-tile) are computed
//   once, with load_box's operations, into shared memory (one array a
//   field, so that 32 boxes fall in 32 banks).
// - Exact circle skip: a pair whose centres lie farther apart than
//   r_a + r_b + kSkipSlack (r = the circumradius) gets IoU 0 without the
//   clip (see kSkipSlack for why that is exact), written by its own thread.
// - Compacted clip: the pairs left are queued in shared memory
//   (__ballot_sync and __popc prefixes, one atomicAdd a warp), and the
//   CTA's threads take them in order, so that every lane of a busy warp
//   runs a clip.
// - Compacted candidates: only the valid candidates are appended, in the
//   formulation's order; the centroid, atan2, stable sort and fan run over
//   those n <= 24.  In the 24-slot formulation the invalid slots sort last
//   at +inf and add exact zeros to the fan, so the result is the same bit
//   for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr float kMargin = 1e-2f;
constexpr float kSegMargin = 1e-3f;
constexpr int kCand = 24;
constexpr int kTile = 16;                 // boxes a side of a CTA's tile
constexpr int kThreads = kTile * kTile;  // one pair a thread in the skip test
constexpr unsigned kFull = 0xffffffffu;

// The circle skip's slack, in metres (SKIP_SLACK in ops/rotated_iou.py).
// Every corner lies within r = sqrt(w*w + l*l) / 2 of its centre, up to the
// rounding of the corner (~1e-6 of the coordinates).  A clip candidate is
// valid only if
// (1) it is a corner of one box that passes the other's containment test:
//     then it lies within sqrt((hx + m)^2 + (hy + m)^2) <= r + m sqrt(2) of
//     the other centre (m = kMargin), so the centres are within
//     r_a + r_b + 0.0142; or
// (2) it is an edge crossing whose segments' bounding boxes meet (`rect`,
//     exact min/max with no margin) and whose four straddle signs pass.  If
//     the segments lie more than kSkipSlack apart, the exact signs cannot
//     all pass, so a computed sign is wrong, which needs an endpoint within
//     rounding (~1e-5 m) of the other segment's line, outside that segment.
//     Then either the other segment's endpoints lie on one side of the
//     first line by a margin far above rounding and a sign fails, or all
//     four endpoints lie within rounding of one line; the segments are then
//     kSkipSlack apart along that line, their bounding boxes kSkipSlack /
//     sqrt(2) apart on one axis, and `rect` fails.
// So a pair whose centres are farther apart than r_a + r_b + kSkipSlack has
// no valid candidate: the clip returns 0 and the IoU is 0 / max(sa + sb,
// eps) = +0, which the skip writes.  The test uses rounded operations, and
// a NaN in it never skips.  tests/test_torch_ops.py sweeps the premise
// against the plain and the JAX IoU.
constexpr float kSkipSlack = 0.05f;

struct Box {
  float cx, cy, hx, hy, area;
  float px[4], py[4];
  float ncos, nsin;  // cos/sin of the negated heading (containment test)
};

// a box's record: the Box fields, then its circumradius
enum Field { kCx, kCy, kHx, kHy, kArea, kPx, kPy = kPx + 4, kNcos = kPy + 4, kNsin, kRadius,
             kFields };

__device__ __forceinline__ Box load_box(const float* b) {
  Box r;
  r.cx = b[0];
  r.cy = b[1];
  r.area = b[3] * b[4];
  r.hx = b[3] / 2.0f;
  r.hy = b[4] / 2.0f;
  // cos and sin in double, rounded once to float, as the plain version
  // takes them (ops/rotated_iou.py, _cos_sin): cosf / sinf may round the
  // other way, and an ulp in a corner can move it across the containment
  // margin, which changes the clipped polygon (0.3 % of the IoU on
  // car-sized boxes a few centimetres and 0.01 rad apart)
  const float c = (float)cos((double)b[6]);
  const float s = (float)sin((double)b[6]);
  const float sx[4] = {-r.hx, r.hx, r.hx, -r.hx};
  const float sy[4] = {-r.hy, -r.hy, r.hy, r.hy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r.px[k] = sx[k] * c - sy[k] * s + r.cx;
    r.py[k] = sx[k] * s + sy[k] * c + r.cy;
  }
  r.ncos = (float)cos(-(double)b[6]);
  r.nsin = (float)sin(-(double)b[6]);
  return r;
}

__device__ __forceinline__ Box rec_box(const float (*rec)[2 * kTile], int k) {
  Box r;
  r.cx = rec[kCx][k];
  r.cy = rec[kCy][k];
  r.hx = rec[kHx][k];
  r.hy = rec[kHy][k];
  r.area = rec[kArea][k];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    r.px[c] = rec[kPx + c][k];
    r.py[c] = rec[kPy + c][k];
  }
  r.ncos = rec[kNcos][k];
  r.nsin = rec[kNsin][k];
  return r;
}

// torch.minimum / torch.maximum: a NaN operand gives NaN, where fminf /
// fmaxf return the other operand.  Only the overlap's cap and the IoU's
// denominator need them, so that a NaN area or fan reaches the IoU as in the
// plain version and the JAX package's.  The clip keeps fminf / fmaxf: a
// NaN in any of a candidate's eight coordinates makes s1 * s2 NaN, so the
// candidate is invalid whatever `rect` and `on_seg` say.
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float cross3(float x1, float y1, float x2, float y2, float x0,
                                        float y0) {
  return (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
}

__device__ __forceinline__ bool inside(const Box& box, float px, float py) {
  const float dx = px - box.cx;
  const float dy = py - box.cy;
  const float rx = dx * box.ncos - dy * box.nsin;
  const float ry = dx * box.nsin + dy * box.ncos;
  return fabsf(rx) < box.hx + kMargin && fabsf(ry) < box.hy + kMargin;
}

__device__ float overlap(const Box& a, const Box& b) {
  float xs[kCand], ys[kCand], ang[kCand];
  int n = 0;  // valid candidates, appended in the order of the formulation
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float p0x = a.px[i], p0y = a.py[i];
    const float p1x = a.px[(i + 1) % 4], p1y = a.py[(i + 1) % 4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float q0x = b.px[j], q0y = b.py[j];
      const float q1x = b.px[(j + 1) % 4], q1y = b.py[(j + 1) % 4];
      const bool rect = fminf(p0x, p1x) <= fmaxf(q0x, q1x) && fminf(q0x, q1x) <= fmaxf(p0x, p1x) &&
                        fminf(p0y, p1y) <= fmaxf(q0y, q1y) && fminf(q0y, q1y) <= fmaxf(p0y, p1y);
      const float s1 = cross3(q0x, q0y, p1x, p1y, p0x, p0y);
      const float s2 = cross3(p1x, p1y, q1x, q1y, p0x, p0y);
      const float s3 = cross3(p0x, p0y, q1x, q1y, q0x, q0y);
      const float s4 = cross3(q1x, q1y, p1x, p1y, q0x, q0y);
      bool valid = rect && (s1 * s2 > 0.f) && (s3 * s4 > 0.f);

      const float s5 = cross3(q1x, q1y, p1x, p1y, p0x, p0y);
      const bool use_fast = fabsf(s5 - s1) > kEps;
      const float denom_fast = use_fast ? s5 - s1 : 1.0f;
      const float fast_x = (s5 * q0x - s1 * q1x) / denom_fast;
      const float fast_y = (s5 * q0y - s1 * q1y) / denom_fast;

      const float a0 = p0y - p1y, b0 = p1x - p0x, c0 = p0x * p1y - p1x * p0y;
      const float a1 = q0y - q1y, b1 = q1x - q0x, c1 = q0x * q1y - q1x * q0y;
      const float D = a0 * b1 - a1 * b0;
      const float D_safe = fabsf(D) > 0.f ? D : 1.0f;
      const float slow_x = (b0 * c1 - b1 * c0) / D_safe;
      const float slow_y = (a1 * c0 - a0 * c1) / D_safe;
      const float D_scale = fabsf(a0 * b1) + fabsf(a1 * b0);
      valid = valid && (use_fast || fabsf(D) > 1e-5f * D_scale);

      const float ix = use_fast ? fast_x : slow_x;
      const float iy = use_fast ? fast_y : slow_y;
      const bool on_seg =
          ix >= fminf(p0x, p1x) - kSegMargin && ix <= fmaxf(p0x, p1x) + kSegMargin &&
          iy >= fminf(p0y, p1y) - kSegMargin && iy <= fmaxf(p0y, p1y) + kSegMargin &&
          ix >= fminf(q0x, q1x) - kSegMargin && ix <= fmaxf(q0x, q1x) + kSegMargin &&
          iy >= fminf(q0y, q1y) - kSegMargin && iy <= fmaxf(q0y, q1y) + kSegMargin;
      if (valid && on_seg) {
        xs[n] = ix;
        ys[n] = iy;
        ++n;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (inside(a, b.px[k], b.py[k])) {
      xs[n] = b.px[k];
      ys[n] = b.py[k];
      ++n;
    }
    if (inside(b, a.px[k], a.py[k])) {
      xs[n] = a.px[k];
      ys[n] = a.py[k];
      ++n;
    }
  }
  if (n == 0) return 0.f;

  float sx = 0.f, sy = 0.f;
  for (int k = 0; k < n; ++k) {
    sx += xs[k];
    sy += ys[k];
  }
  const float cx0 = sx / (float)n;
  const float cy0 = sy / (float)n;
  for (int k = 0; k < n; ++k) ang[k] = atan2f(ys[k] - cy0, xs[k] - cx0);

  // stable insertion sort by angle
  for (int k = 1; k < n; ++k) {
    const float ka = ang[k], kx = xs[k], ky = ys[k];
    int j = k - 1;
    while (j >= 0 && ang[j] > ka) {
      ang[j + 1] = ang[j];
      xs[j + 1] = xs[j];
      ys[j + 1] = ys[j];
      --j;
    }
    ang[j + 1] = ka;
    xs[j + 1] = kx;
    ys[j + 1] = ky;
  }

  const float x0 = xs[0], y0 = ys[0];
  float area2 = 0.f;
  float vx = 0.f, vy = 0.f;  // vertex 0 relative to itself
  for (int k = 1; k < n; ++k) {
    const float nx = xs[k] - x0;
    const float ny = ys[k] - y0;
    area2 += vx * ny - nx * vy;
    vx = nx;
    vy = ny;
  }
  const float area = fabsf(area2) / 2.0f;
  const float cap = nan_min(a.area, b.area);
  return nan_min(area, cap);
}

__global__ void __launch_bounds__(kThreads)
    iou_self_kernel(const float* __restrict__ boxes, int K, float* __restrict__ iou) {
  __shared__ float rec[kFields][2 * kTile];  // boxes i0.. then j0..
  __shared__ uint8_t queue[kThreads];
  __shared__ int queued;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const float* bb = boxes + (size_t)blockIdx.z * K * 7;
  float* ob = iou + (size_t)blockIdx.z * K * K;
  if (tid == 0) queued = 0;
  if (tid < 2 * kTile) {
    const int k = tid < kTile ? i0 + tid : j0 + tid - kTile;
    if (k < K) {
      const float* src = bb + (size_t)k * 7;
      const Box r = load_box(src);
      rec[kCx][tid] = r.cx;
      rec[kCy][tid] = r.cy;
      rec[kHx][tid] = r.hx;
      rec[kHy][tid] = r.hy;
      rec[kArea][tid] = r.area;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        rec[kPx + c][tid] = r.px[c];
        rec[kPy + c][tid] = r.py[c];
      }
      rec[kNcos][tid] = r.ncos;
      rec[kNsin][tid] = r.nsin;
      rec[kRadius][tid] = __fmul_rn(0.5f, __fsqrt_rn(__fadd_rn(__fmul_rn(src[3], src[3]),
                                                               __fmul_rn(src[4], src[4]))));
    }
  }
  __syncthreads();

  const int il = tid / kTile, jl = tid % kTile;
  const int i = i0 + il, j = j0 + jl;
  bool clip = false;
  if (i < K && j < K) {
    const float dx = __fsub_rn(rec[kCx][kTile + jl], rec[kCx][il]);
    const float dy = __fsub_rn(rec[kCy][kTile + jl], rec[kCy][il]);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float lim = __fadd_rn(__fadd_rn(rec[kRadius][il], rec[kRadius][kTile + jl]), kSkipSlack);
    clip = !(d2 > __fmul_rn(lim, lim));
    if (!clip) ob[(size_t)i * K + j] = 0.f;
  }
  const int lane = tid & 31;
  const unsigned ballot = __ballot_sync(kFull, clip);
  int base = 0;
  if (lane == 0 && ballot) base = atomicAdd(&queued, __popc(ballot));
  base = __shfl_sync(kFull, base, 0);
  if (clip) queue[base + __popc(ballot & ((1u << lane) - 1u))] = (uint8_t)tid;
  __syncthreads();

  const int n = queued;
  for (int q = tid; q < n; q += kThreads) {
    const int p = queue[q];
    const int qi = p / kTile, qj = p % kTile;
    const Box A = rec_box(rec, qi);
    const Box Bx = rec_box(rec, kTile + qj);
    const float ov = overlap(A, Bx);
    ob[(size_t)(i0 + qi) * K + j0 + qj] = ov / nan_max(A.area + Bx.area - ov, kEps);
  }
}

}  // namespace

// boxes: (B, K, 7) float32; iou: (B, K, K) float32.  B <= 65535.
extern "C" int pdanet_iou_bev_self(const float* boxes, int B, int K, float* iou, void* stream) {
  if (B == 0 || K == 0) return 0;
  const int tiles = (K + kTile - 1) / kTile;
  iou_self_kernel<<<dim3(tiles, tiles, B), kThreads, 0, (cudaStream_t)stream>>>(boxes, K, iou);
  return (int)cudaGetLastError();
}
