"""Host rotated BEV IoU: the reference's ``boxes_bev_iou_cpu``
(``iou3d_nms_utils.py:12-28`` over ``iou3d_cpu.cpp:1-252``), copied from
``pdanet_tpu/utils/iou3d_np.py``.  Used by the gt-sampling augmentor's
collision test.  The overlap runs the port's g++ host library
(``native.rotated_overlap``), as the JAX package runs its own; the numpy
convex-clip loop stays beside it as ``boxes_bev_overlap_plain``.
"""

import numpy as np

from .. import native


def _box_corners_bev(boxes):
    """(N, 7) -> (N, 4, 2) BEV corners (counter-clockwise)."""
    dx2, dy2 = boxes[:, 3] / 2.0, boxes[:, 4] / 2.0
    # counter-clockwise winding: the Sutherland-Hodgman inside-test below
    # keeps the left side of each directed clip edge, so clockwise corners
    # would clip every polygon to empty (IoU silently 0 for all pairs).
    template = np.array(
        [[1, 1], [-1, 1], [-1, -1], [1, -1]], dtype=np.float32
    )  # x,y signs
    local = np.stack([template[:, 0][None] * dx2[:, None],
                      template[:, 1][None] * dy2[:, None]], axis=-1)  # (N,4,2)
    cosa, sina = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = local[..., 0] * cosa[:, None] - local[..., 1] * sina[:, None]
    y = local[..., 0] * sina[:, None] + local[..., 1] * cosa[:, None]
    return np.stack([x + boxes[:, 0:1], y + boxes[:, 1:2]], axis=-1)


def _polygon_clip(subject, clip):
    """Sutherland–Hodgman: clip polygon ``subject`` by convex ``clip``."""
    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) >= -1e-12

    def intersect(p1, p2, a, b):
        dc = (a[0] - b[0], a[1] - b[1])
        dp = (p1[0] - p2[0], p1[1] - p2[1])
        n1 = a[0] * b[1] - a[1] * b[0]
        n2 = p1[0] * p2[1] - p1[1] * p2[0]
        denom = dc[0] * dp[1] - dc[1] * dp[0]
        if abs(denom) < 1e-12:
            return p2
        return (
            (n1 * dp[0] - n2 * dc[0]) / denom,
            (n1 * dp[1] - n2 * dc[1]) / denom,
        )

    output = list(subject)
    for i in range(len(clip)):
        a, b = clip[i - 1], clip[i]
        input_list = output
        output = []
        if not input_list:
            break
        s = input_list[-1]
        for e in input_list:
            if inside(e, a, b):
                if not inside(s, a, b):
                    output.append(intersect(s, e, a, b))
                output.append(e)
            elif inside(s, a, b):
                output.append(intersect(s, e, a, b))
            s = e
    return output


def _polygon_area(poly):
    if len(poly) < 3:
        return 0.0
    area = 0.0
    for i in range(len(poly)):
        x1, y1 = poly[i - 1]
        x2, y2 = poly[i]
        area += x1 * y2 - x2 * y1
    return abs(area) / 2.0


def boxes_bev_overlap_cpu(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) float32 rotated BEV intersection areas, by
    the host library (in float64, rounded once)."""
    boxes_a = np.asarray(boxes_a)
    boxes_b = np.asarray(boxes_b)
    if not (len(boxes_a) and len(boxes_b)):
        return np.zeros((len(boxes_a), len(boxes_b)), dtype=np.float32)
    cols = [0, 1, 3, 4, 6]
    return native.rotated_overlap(boxes_a[:, cols], boxes_b[:, cols]).astype(np.float32)


def boxes_bev_overlap_plain(boxes_a, boxes_b):
    """The numpy plain version of ``boxes_bev_overlap_cpu``: a
    Sutherland-Hodgman clip a pair in Python."""
    boxes_a = np.asarray(boxes_a)
    boxes_b = np.asarray(boxes_b)
    ca = _box_corners_bev(np.asarray(boxes_a, dtype=np.float64))
    cb = _box_corners_bev(np.asarray(boxes_b, dtype=np.float64))
    out = np.zeros((len(boxes_a), len(boxes_b)), dtype=np.float32)
    for i in range(len(boxes_a)):
        for j in range(len(boxes_b)):
            inter = _polygon_clip([tuple(p) for p in ca[i]], [tuple(p) for p in cb[j]])
            out[i, j] = _polygon_area(inter)
    return out


def boxes_bev_iou_cpu(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) rotated BEV IoU."""
    boxes_a = np.asarray(boxes_a, dtype=np.float32)
    boxes_b = np.asarray(boxes_b, dtype=np.float32)
    overlap = boxes_bev_overlap_cpu(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return overlap / np.clip(area_a + area_b - overlap, 1e-6, None)
