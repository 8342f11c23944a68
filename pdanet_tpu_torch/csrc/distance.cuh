// The squared distance of FPS and the ball query (fps.cu, ball_query.cu),
// and an exact lower bound of it over a box of points.
//
// Both kernels hold their indices equal to the JAX package's, so the
// distance is dx*dx + dy*dy + dz*dz left to right with round-to-nearest
// intrinsics (the library builds with --fmad=false, and no contraction
// may change a tie or a d2 < r2 test).

#pragma once

#include <cuda_runtime.h>

namespace pdanet_dist {

__device__ __forceinline__ float dist2(float x, float y, float z, float cx, float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Lower bound of dist2(p, c) over every point p in the box [lo, hi],
// computed with the same rounded operations in the same order.
// Round-to-nearest is monotone and sign-symmetric: for a coordinate
// x >= lo > c, fl(x - c) >= fl(lo - c) >= 0; for x <= hi < c,
// |fl(x - c)| = fl(c - x) >= fl(c - hi); otherwise the gap is
// 0 <= |fl(x - c)|.  Each square and each sum is monotone in its
// operands, so the computed dist2 of every point in the box is >= this
// bound, exactly: a test against it needs no margin.
__device__ __forceinline__ float box_lower_bound(float lox, float loy, float loz, float hix,
                                                 float hiy, float hiz, float cx, float cy,
                                                 float cz) {
  const float gx = lox > cx ? __fsub_rn(lox, cx) : (cx > hix ? __fsub_rn(cx, hix) : 0.f);
  const float gy = loy > cy ? __fsub_rn(loy, cy) : (cy > hiy ? __fsub_rn(cy, hiy) : 0.f);
  const float gz = loz > cz ? __fsub_rn(loz, cz) : (cz > hiz ? __fsub_rn(cz, hiz) : 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

}  // namespace pdanet_dist
