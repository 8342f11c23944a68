// Host-side library of pdanet_tpu_torch: the rotated BEV overlap, points in
// boxes and the grid-hash voxelizer, in plain C++17.
//
// The reference implements these host/CPU op halves in C++ behind torch
// extensions (iou3d_cpu.cpp:1-252 rotated overlap, the spconv
// Point2VoxelCPU3d voxelizer used by data_processor.py:115-143, and
// roiaware_pool3d.cpp's points_in_boxes_cpu).  They run on the host side of
// the pipeline (the gt sampler's collision test, voxelization in the data
// loader, the gt database, offline eval matching), where numpy's Python
// loops and large broadcasts cost real time on the CPU cores that feed the
// GPU.
//
// Compiled with g++ at first use (pdanet_tpu_torch/native/__init__.py) into
// a shared library bound with ctypes.  The arithmetic is the JAX package's
// pdanet_tpu/native/src/pdanet_host.cc, statement for statement, so both
// packages' default host paths give the same bits.  Each function keeps its
// numpy plain version beside its caller; tests/test_torch_native.py holds
// the two equal.
//
// ABI: extern "C", row-major contiguous arrays, caller allocates outputs.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Rotated BEV overlap: Sutherland–Hodgman convex clip per pair.
// Boxes are (cx, cy, w, h, angle); corners wound counter-clockwise.
// Mirrors utils/iou3d_np._bev_overlap_plain (and matches the 24-candidate
// kitti_object_eval_python/rotate_iou._rotate_overlap_plain to float
// precision).
// ---------------------------------------------------------------------------

struct Pt {
  double x, y;
};

inline void box_corners(const double* b, Pt* c) {
  const double hw = b[2] * 0.5, hh = b[3] * 0.5;
  const double ca = std::cos(b[4]), sa = std::sin(b[4]);
  // counter-clockwise: (+,+), (-,+), (-,-), (+,-)
  const double sx[4] = {hw, -hw, -hw, hw};
  const double sy[4] = {hh, hh, -hh, -hh};
  for (int i = 0; i < 4; ++i) {
    c[i].x = sx[i] * ca - sy[i] * sa + b[0];
    c[i].y = sx[i] * sa + sy[i] * ca + b[1];
  }
}

inline double cross_edge(const Pt& a, const Pt& b, const Pt& p) {
  return (b.x - a.x) * (p.y - a.y) - (b.y - a.y) * (p.x - a.x);
}

// Clip convex polygon (poly, n) by the directed edge a->b (keep left side).
// Writes into out, returns new vertex count.  Max output n+1 per edge.
inline int clip_edge(const Pt* poly, int n, const Pt& a, const Pt& b,
                     Pt* out) {
  if (n == 0) return 0;
  int m = 0;
  Pt s = poly[n - 1];
  double ss = cross_edge(a, b, s);
  for (int i = 0; i < n; ++i) {
    const Pt e = poly[i];
    const double se = cross_edge(a, b, e);
    const bool ein = se >= -1e-12, sin_ = ss >= -1e-12;
    if (ein != sin_) {
      // segment s->e crosses the clip line: line-line intersection.
      const double dcx = a.x - b.x, dcy = a.y - b.y;
      const double dpx = s.x - e.x, dpy = s.y - e.y;
      const double n1 = a.x * b.y - a.y * b.x;
      const double n2 = s.x * e.y - s.y * e.x;
      const double denom = dcx * dpy - dcy * dpx;
      if (std::fabs(denom) < 1e-12) {
        out[m++] = e;  // parallel: the numpy plain version keeps p2 (== e)
      } else {
        out[m].x = (n1 * dpx - n2 * dcx) / denom;
        out[m].y = (n1 * dpy - n2 * dcy) / denom;
        ++m;
      }
    }
    if (ein) out[m++] = e;
    s = e;
    ss = se;
  }
  return m;
}

inline double pair_overlap(const Pt* ca, const Pt* cb) {
  // Clip box A by box B's 4 edges.  4 verts + up to 1 per clip edge -> <=16.
  Pt buf0[16], buf1[16];
  std::memcpy(buf0, ca, 4 * sizeof(Pt));
  int n = 4;
  const Pt* cur = buf0;
  Pt* nxt = buf1;
  for (int i = 0; i < 4; ++i) {
    const Pt& a = cb[(i + 3) & 3];
    const Pt& b = cb[i];
    n = clip_edge(cur, n, a, b, nxt);
    if (n == 0) return 0.0;
    const Pt* t = cur;
    cur = nxt;
    nxt = const_cast<Pt*>(t);
  }
  if (n < 3) return 0.0;
  double area = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& p = cur[(i + n - 1) % n];
    const Pt& q = cur[i];
    area += p.x * q.y - q.x * p.y;
  }
  return std::fabs(area) * 0.5;
}

}  // namespace

extern "C" {

// a: (n, 5) f64 (cx, cy, w, h, angle); b: (k, 5) f64; out: (n, k) f64
// intersection areas.
void rotated_overlap_f64(const double* a, int64_t n, const double* b,
                         int64_t k, double* out) {
  std::vector<Pt> ca(static_cast<size_t>(n) * 4);
  std::vector<Pt> cb(static_cast<size_t>(k) * 4);
  for (int64_t i = 0; i < n; ++i) box_corners(a + i * 5, ca.data() + i * 4);
  for (int64_t j = 0; j < k; ++j) box_corners(b + j * 5, cb.data() + j * 4);
  for (int64_t i = 0; i < n; ++i) {
    const Pt* cai = ca.data() + i * 4;
    double* row = out + i * k;
    for (int64_t j = 0; j < k; ++j) {
      row[j] = pair_overlap(cai, cb.data() + j * 4);
    }
  }
}

// points: (n, 3) f32; boxes: (m, 7) f32 (cx cy cz dx dy dz heading);
// out: (m, n) i32 0/1 — mirrors utils/box_utils._points_in_boxes_plain
// (roiaware_pool3d_kernel semantics: z inclusive, xy strict + 1e-5 slack).
void points_in_boxes_f32(const float* points, int64_t n, const float* boxes,
                         int64_t m, int32_t* out) {
  for (int64_t bi = 0; bi < m; ++bi) {
    const float* b = boxes + bi * 7;
    const float ca = std::cos(b[6]), sa = std::sin(b[6]);
    const float hx = b[3] * 0.5f + 1e-5f, hy = b[4] * 0.5f + 1e-5f,
                hz = b[5] * 0.5f;
    int32_t* row = out + bi * n;
    for (int64_t pi = 0; pi < n; ++pi) {
      const float dx = points[pi * 3 + 0] - b[0];
      const float dy = points[pi * 3 + 1] - b[1];
      const float dz = points[pi * 3 + 2] - b[2];
      const float lx = dx * ca + dy * sa;
      const float ly = -dx * sa + dy * ca;
      row[pi] = (std::fabs(dz) <= hz) && (std::fabs(lx) < hx) &&
                (std::fabs(ly) < hy);
    }
  }
}

// Grid-hash voxelizer.  Mirrors datasets/processor/data_processor.py's
// _voxelize_plain (the numpy replacement of spconv Point2VoxelCPU3d):
// first-come point order within a voxel, voxels ordered by first
// appearance, capped points-per-voxel and voxel count; counts report
// min(total, max_pts).
//
// points: (n, c) f32 with xyz leading.  pcr: (6,) f32 range.
// vsize: (3,) f32.  grid: (3,) i64 (gx, gy, gz).
// voxels: (max_voxels, max_pts, c) f32 zero-initialised by caller.
// coords: (max_voxels, 3) i32 output in zyx order.
// num_points: (max_voxels,) i32.
// Returns the number of voxels written.
int64_t voxelize_f32(const float* points, int64_t n, int64_t c,
                     const float* pcr, const float* vsize, const int64_t* grid,
                     int64_t max_pts, int64_t max_voxels, float* voxels,
                     int32_t* coords, int32_t* num_points) {
  std::unordered_map<int64_t, int64_t> slot_of;
  slot_of.reserve(static_cast<size_t>(max_voxels) * 2);
  std::vector<int32_t> total_count(static_cast<size_t>(max_voxels), 0);
  int64_t num_voxels = 0;
  const int64_t gx = grid[0], gy = grid[1], gz = grid[2];
  for (int64_t pi = 0; pi < n; ++pi) {
    const float* p = points + pi * c;
    const int64_t ix = static_cast<int64_t>(
        std::floor((p[0] - pcr[0]) / vsize[0]));
    const int64_t iy = static_cast<int64_t>(
        std::floor((p[1] - pcr[1]) / vsize[1]));
    const int64_t iz = static_cast<int64_t>(
        std::floor((p[2] - pcr[2]) / vsize[2]));
    if (ix < 0 || iy < 0 || iz < 0 || ix >= gx || iy >= gy || iz >= gz)
      continue;
    const int64_t vid = (iz * gy + iy) * gx + ix;
    auto it = slot_of.find(vid);
    int64_t slot;
    if (it == slot_of.end()) {
      if (num_voxels >= max_voxels) continue;  // cap: drop new voxels
      slot = num_voxels++;
      slot_of.emplace(vid, slot);
      coords[slot * 3 + 0] = static_cast<int32_t>(iz);
      coords[slot * 3 + 1] = static_cast<int32_t>(iy);
      coords[slot * 3 + 2] = static_cast<int32_t>(ix);
    } else {
      slot = it->second;
    }
    const int32_t cnt = total_count[slot]++;
    if (cnt < max_pts) {
      std::memcpy(voxels + (slot * max_pts + cnt) * c, p,
                  static_cast<size_t>(c) * sizeof(float));
    }
  }
  for (int64_t s = 0; s < num_voxels; ++s) {
    num_points[s] = total_count[s] < max_pts
                        ? total_count[s]
                        : static_cast<int32_t>(max_pts);
  }
  return num_voxels;
}

}  // extern "C"
