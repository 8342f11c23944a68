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
// workarounds.
//
// What bounds it on the H100: arithmetic and registers -- ~1.5k flops and
// 24 candidate vertices per pair, nothing re-read from memory but the two
// boxes.  Design: one thread per (b, i, j) pair, boxes read through L1;
// the 24-vertex arrays spill to local memory (L1-resident).  Tiling boxes
// through shared memory and sharing the per-box trig are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr float kMargin = 1e-2f;
constexpr float kSegMargin = 1e-3f;
constexpr int kCand = 24;

struct Box {
  float cx, cy, hx, hy, w, l;
  float px[4], py[4];
  float ncos, nsin;  // cos/sin of the negated heading (containment test)
};

__device__ __forceinline__ Box load_box(const float* b) {
  Box r;
  r.cx = b[0];
  r.cy = b[1];
  r.w = b[3];
  r.l = b[4];
  r.hx = b[3] / 2.0f;
  r.hy = b[4] / 2.0f;
  const float c = cosf(b[6]);
  const float s = sinf(b[6]);
  const float sx[4] = {-r.hx, r.hx, r.hx, -r.hx};
  const float sy[4] = {-r.hy, -r.hy, r.hy, r.hy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r.px[k] = sx[k] * c - sy[k] * s + r.cx;
    r.py[k] = sx[k] * s + sy[k] * c + r.cy;
  }
  r.ncos = cosf(-b[6]);
  r.nsin = sinf(-b[6]);
  return r;
}

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
  bool vs[kCand];
  int n = 0;
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
      valid = valid && on_seg;
      xs[n] = valid ? ix : 0.f;
      ys[n] = valid ? iy : 0.f;
      vs[n] = valid;
      ++n;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bool in = inside(a, b.px[k], b.py[k]);
    xs[n] = in ? b.px[k] : 0.f;
    ys[n] = in ? b.py[k] : 0.f;
    vs[n] = in;
    ++n;
    in = inside(b, a.px[k], a.py[k]);
    xs[n] = in ? a.px[k] : 0.f;
    ys[n] = in ? a.py[k] : 0.f;
    vs[n] = in;
    ++n;
  }

  int cnt = 0;
  float sx = 0.f, sy = 0.f;
  for (int k = 0; k < kCand; ++k) {
    if (vs[k]) {
      ++cnt;
      sx += xs[k];
      sy += ys[k];
    }
  }
  if (cnt == 0) return 0.f;
  const float cx0 = sx / (float)cnt;
  const float cy0 = sy / (float)cnt;
  for (int k = 0; k < kCand; ++k)
    ang[k] = vs[k] ? atan2f(ys[k] - cy0, xs[k] - cx0) : CUDART_INF_F;

  // stable insertion sort by angle; invalid candidates (+inf) sink to the end
  for (int k = 1; k < kCand; ++k) {
    const float ka = ang[k], kx = xs[k], ky = ys[k];
    const bool kv = vs[k];
    int j = k - 1;
    while (j >= 0 && ang[j] > ka) {
      ang[j + 1] = ang[j];
      xs[j + 1] = xs[j];
      ys[j + 1] = ys[j];
      vs[j + 1] = vs[j];
      --j;
    }
    ang[j + 1] = ka;
    xs[j + 1] = kx;
    ys[j + 1] = ky;
    vs[j + 1] = kv;
  }

  const float x0 = xs[0], y0 = ys[0];
  float area2 = 0.f;
  float vx = 0.f, vy = 0.f;  // vertex 0 relative to itself
  for (int k = 1; k < kCand; ++k) {
    const float nx = (vs[k] ? xs[k] : x0) - x0;
    const float ny = (vs[k] ? ys[k] : y0) - y0;
    area2 += vx * ny - nx * vy;
    vx = nx;
    vy = ny;
  }
  const float area = fabsf(area2) / 2.0f;
  const float cap = fminf(a.w * a.l, b.w * b.l);
  return fminf(area, cap);
}

__global__ void iou_self_kernel(const float* __restrict__ boxes, int B, int K,
                                float* __restrict__ iou) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)B * K * K;
  if (t >= total) return;
  const int j = (int)(t % K);
  const long long bi = t / K;
  const int i = (int)(bi % K);
  const int b = (int)(bi / K);
  const float* bb = boxes + (size_t)b * K * 7;
  const Box A = load_box(bb + (size_t)i * 7);
  const Box Bx = load_box(bb + (size_t)j * 7);
  const float ov = overlap(A, Bx);
  const float sa = A.w * A.l;
  const float sb = Bx.w * Bx.l;
  iou[t] = ov / fmaxf(sa + sb - ov, kEps);
}

}  // namespace

// boxes: (B, K, 7) float32; iou: (B, K, K) float32.
extern "C" int pdanet_iou_bev_self(const float* boxes, int B, int K, float* iou, void* stream) {
  const long long total = (long long)B * K * K;
  if (total == 0) return 0;
  const int threads = 128;
  const int blocks = (int)((total + threads - 1) / threads);
  iou_self_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(boxes, B, K, iou);
  return (int)cudaGetLastError();
}
