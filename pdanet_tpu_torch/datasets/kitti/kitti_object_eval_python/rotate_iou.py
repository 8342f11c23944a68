"""Rotated IoU for offline evaluation.

Counterpart of ``pcdet/datasets/kitti/kitti_object_eval_python/rotate_iou.py``
(numba.cuda there), copied from the JAX package's.  ``rotate_overlap`` runs
the port's g++ host library (``native.rotated_overlap``, a convex clip a
pair), as the JAX package runs its own.  Its numpy plain version,
``rotate_overlap_plain``, has the geometry of the on-device rotated IoU:
enumerate 16 edge intersections + 8 contained corners per pair, sort by
angle, shoelace, vectorized over the (N, K) pair grid.

Boxes here are BEV rectangles ``[cx, cy, w, h, angle]`` (the KITTI eval
passes camera-frame (x, z, l, w, ry)).
"""

import numpy as np

from .... import native

EPS = 1e-8


def _corners(boxes):
    """(N, 5) -> (N, 4, 2)."""
    cx, cy, w, h, ang = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3], boxes[:, 4]
    sx = np.stack([-w, w, w, -w], axis=-1) / 2.0
    sy = np.stack([-h, -h, h, h], axis=-1) / 2.0
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    px = sx * c - sy * s + cx[:, None]
    py = sx * s + sy * c + cy[:, None]
    return np.stack([px, py], axis=-1)


def _cross3(p1, p2, p0):
    return (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) - (
        p2[..., 0] - p0[..., 0]
    ) * (p1[..., 1] - p0[..., 1])


def _pair_intersections(ca, cb):
    """(N, 1, 4, 2) x (1, K, 4, 2) -> pts (N, K, 16, 2), valid (N, K, 16)."""
    a0, a1 = ca, np.roll(ca, -1, axis=-2)
    b0, b1 = cb, np.roll(cb, -1, axis=-2)
    p0 = a0[..., :, None, :]
    p1 = a1[..., :, None, :]
    q0 = b0[..., None, :, :]
    q1 = b1[..., None, :, :]

    s1 = _cross3(q0, p1, p0)
    s2 = _cross3(p1, q1, p0)
    s3 = _cross3(p0, q1, q0)
    s4 = _cross3(q1, p1, q0)
    valid = (s1 * s2 > 0) & (s3 * s4 > 0)

    s5 = _cross3(q1, p1, p0)
    denom = np.where(np.abs(s5 - s1) > EPS, s5 - s1, 1.0)
    pts = (s5[..., None] * q0 - s1[..., None] * q1) / denom[..., None]
    pts = np.where(valid[..., None], pts, 0.0)
    shp = pts.shape[:-3]
    return pts.reshape(shp + (16, 2)), valid.reshape(shp + (16,))


def _corners_in_quad(quad, pts):
    """quad (..., 4, 2) convex CCW/CW; pts (..., P, 2) -> (..., P) bool."""
    a = quad[..., :, None, :]  # (..., 4, P, 2) edges vs pts
    b = np.roll(quad, -1, axis=-2)[..., :, None, :]
    p = pts[..., None, :, :]
    cross = (b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]
    ) * (p[..., 0] - a[..., 0])
    return np.all(cross >= -1e-9, axis=-2) | np.all(cross <= 1e-9, axis=-2)


def rotate_overlap(boxes, qboxes):
    """(N, 5) x (K, 5) -> (N, K) float32 rotated intersection areas, by the
    host library (in float64, rounded once)."""
    N, K = len(boxes), len(qboxes)
    if N == 0 or K == 0:
        return np.zeros((N, K), dtype=np.float32)
    return native.rotated_overlap(boxes, qboxes).astype(np.float32)


def rotate_overlap_plain(boxes, qboxes):
    """The numpy plain version of ``rotate_overlap``.  On edges that are
    collinear to ~1e-12 m it can drop a corner (the JAX package's numpy path
    does the same; ROADMAP queue 3)."""
    N, K = len(boxes), len(qboxes)
    if N == 0 or K == 0:
        return np.zeros((N, K), dtype=np.float32)
    ca = _corners(boxes.astype(np.float64))[:, None]  # (N, 1, 4, 2)
    cb = _corners(qboxes.astype(np.float64))[None, :]  # (1, K, 4, 2)

    inter_pts, inter_valid = _pair_intersections(ca, cb)
    b_in_a = _corners_in_quad(ca, np.broadcast_to(cb, (N, K, 4, 2)))
    a_in_b = _corners_in_quad(cb, np.broadcast_to(ca, (N, K, 4, 2)))
    corner_pts = np.concatenate(
        [np.broadcast_to(cb, (N, K, 4, 2)), np.broadcast_to(ca, (N, K, 4, 2))],
        axis=-2,
    )  # (N, K, 8, 2)
    corner_valid = np.concatenate([b_in_a, a_in_b], axis=-1)

    pts = np.concatenate([inter_pts, corner_pts], axis=-2)  # (N, K, 24, 2)
    valid = np.concatenate([inter_valid, corner_valid], axis=-1)

    cnt = valid.sum(axis=-1)
    cnt_safe = np.maximum(cnt, 1)
    center = np.where(valid[..., None], pts, 0.0).sum(axis=-2) / cnt_safe[..., None]
    ang = np.arctan2(pts[..., 1] - center[..., None, 1], pts[..., 0] - center[..., None, 0])
    ang = np.where(valid, ang, np.inf)
    order = np.argsort(ang, axis=-1, kind="stable")
    pts_sorted = np.take_along_axis(pts, order[..., None], axis=-2)
    valid_sorted = np.take_along_axis(valid, order, axis=-1)
    p0 = pts_sorted[..., 0:1, :]
    pts_final = np.where(valid_sorted[..., None], pts_sorted, p0)
    v = pts_final - p0
    tri = v[..., :-1, 0] * v[..., 1:, 1] - v[..., :-1, 1] * v[..., 1:, 0]
    area = np.abs(tri.sum(axis=-1)) / 2.0
    return np.where(cnt > 2, area, 0.0).astype(np.float32)


def rotate_iou_eval(boxes, qboxes, criterion=-1):
    """Official rotate_iou_gpu_eval semantics (rotate_iou.py:295-329):
    criterion -1 = IoU, 0 = inter/area_a, 1 = inter/area_b, 2 = raw
    intersection area (used by d3_box_overlap / the ONCE iou3d kernel)."""
    inter = rotate_overlap(boxes, qboxes)
    if criterion == 2:
        return inter
    area_a = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_b = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a, inter.shape).copy()
    else:
        denom = np.broadcast_to(area_b, inter.shape).copy()
    return np.where(denom > 0, inter / np.maximum(denom, EPS), 0.0)
