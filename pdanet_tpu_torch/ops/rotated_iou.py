"""Rotated BEV IoU of box pairs.

Counterpart of ``pdanet_tpu/ops/rotated_iou.py:27-346``, written after its
XLA formulation: per pair, 16 edge-pair intersections and 8 contained
corners, their centroid, a stable angular sort and a triangle fan, with the
JAX package's guards (relative-determinant test, on-segment check,
overlap clamped to the smaller box area so IoU <= 1).  PyTorch runs each
elementwise op as its own kernel, so no product is contracted into an FMA
and coincident edges give exact zero cross products.

``boxes_iou_bev_batched_self`` -- the NMS matrix -- is the op
``<package>::rotated_iou``: the kernel in ``csrc/rotated_iou.cu`` for a
CUDA tensor and :func:`boxes_iou_bev_batched_self_plain` for a CPU
tensor.  The kernel writes IoU 0 without the clip for a pair whose
centres lie farther apart than the sum of the boxes' circumradii and
``SKIP_SLACK``: no corner passes the containment margin and no edge
crossing passes the straddle and bounding-box tests there, so the clip
gives exactly 0 (the argument is at ``kSkipSlack`` in the source; the CPU
tests sweep it).
"""

import torch

from . import cuda_lib

EPS = 1e-8
_MARGIN = 1e-2
_SEG_MARGIN = 1e-3
SKIP_SLACK = 0.05  # metres; kSkipSlack in csrc/rotated_iou.cu
MAX_FRAMES = 65535  # the kernel's grid takes frames on its z axis


def _cos_sin(angle):
    """cos and sin in float64, rounded once to ``angle``'s dtype: the same
    bits on every device (float32 ``cos`` / ``sin`` of the CPU and of CUDA
    differ in the last place, and the clip carries it into the IoU)."""
    a = angle.double()
    return torch.cos(a).to(angle.dtype), torch.sin(a).to(angle.dtype)


def box_corners_bev(boxes):
    """(..., 7) -> x (..., 4), y (..., 4) BEV corners, reference order."""
    cx, cy = boxes[..., 0:1], boxes[..., 1:2]
    hx = boxes[..., 3] / 2.0
    hy = boxes[..., 4] / 2.0
    sx = torch.stack([-hx, hx, hx, -hx], dim=-1)
    sy = torch.stack([-hy, -hy, hy, hy], dim=-1)
    c, s = _cos_sin(boxes[..., 6:7])
    return sx * c - sy * s + cx, sx * s + sy * c + cy


def _pair_overlap(boxes_a, boxes_b):
    """(..., N, 7) x (..., M, 7) -> (..., N, M) rotated BEV overlap."""
    ax, ay = box_corners_bev(boxes_a)  # (..., N, 4)
    bx, by = box_corners_bev(boxes_b)  # (..., M, 4)

    def A(c):  # corner c of a as (..., N, 1)
        return ax[..., :, c:c + 1], ay[..., :, c:c + 1]

    def Bc(c):  # corner c of b as (..., 1, M)
        return bx[..., None, :, c], by[..., None, :, c]

    def cross3(x1, y1, x2, y2, x0, y0):
        return (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)

    cand_x, cand_y, cand_v = [], [], []
    for i in range(4):
        p0x, p0y = A(i)
        p1x, p1y = A((i + 1) % 4)
        for j in range(4):
            q0x, q0y = Bc(j)
            q1x, q1y = Bc((j + 1) % 4)
            rect = (
                (torch.minimum(p0x, p1x) <= torch.maximum(q0x, q1x))
                & (torch.minimum(q0x, q1x) <= torch.maximum(p0x, p1x))
                & (torch.minimum(p0y, p1y) <= torch.maximum(q0y, q1y))
                & (torch.minimum(q0y, q1y) <= torch.maximum(p0y, p1y))
            )
            s1 = cross3(q0x, q0y, p1x, p1y, p0x, p0y)
            s2 = cross3(p1x, p1y, q1x, q1y, p0x, p0y)
            s3 = cross3(p0x, p0y, q1x, q1y, q0x, q0y)
            s4 = cross3(q1x, q1y, p1x, p1y, q0x, q0y)
            valid = rect & (s1 * s2 > 0) & (s3 * s4 > 0)

            s5 = cross3(q1x, q1y, p1x, p1y, p0x, p0y)
            use_fast = torch.abs(s5 - s1) > EPS
            denom_fast = torch.where(use_fast, s5 - s1, 1.0)
            fast_x = (s5 * q0x - s1 * q1x) / denom_fast
            fast_y = (s5 * q0y - s1 * q1y) / denom_fast

            a0, b0 = p0y - p1y, p1x - p0x
            c0 = p0x * p1y - p1x * p0y
            a1, b1 = q0y - q1y, q1x - q0x
            c1 = q0x * q1y - q1x * q0y
            D = a0 * b1 - a1 * b0
            D_safe = torch.where(torch.abs(D) > 0, D, 1.0)
            slow_x = (b0 * c1 - b1 * c0) / D_safe
            slow_y = (a1 * c0 - a0 * c1) / D_safe
            D_scale = torch.abs(a0 * b1) + torch.abs(a1 * b0)
            valid = valid & (use_fast | (torch.abs(D) > 1e-5 * D_scale))

            ix = torch.where(use_fast, fast_x, slow_x)
            iy = torch.where(use_fast, fast_y, slow_y)
            gm = _SEG_MARGIN
            on_seg = (
                (ix >= torch.minimum(p0x, p1x) - gm)
                & (ix <= torch.maximum(p0x, p1x) + gm)
                & (iy >= torch.minimum(p0y, p1y) - gm)
                & (iy <= torch.maximum(p0y, p1y) + gm)
                & (ix >= torch.minimum(q0x, q1x) - gm)
                & (ix <= torch.maximum(q0x, q1x) + gm)
                & (iy >= torch.minimum(q0y, q1y) - gm)
                & (iy <= torch.maximum(q0y, q1y) + gm)
            )
            valid = valid & on_seg
            cand_x.append(torch.where(valid, ix, 0.0))
            cand_y.append(torch.where(valid, iy, 0.0))
            cand_v.append(valid)

    def box_frame(boxes, axis):
        # centre, half extents and cos/sin of the negated heading, shaped to
        # broadcast as the a side (axis -1) or the b side (axis -2)
        return tuple(t.unsqueeze(axis) for t in (
            boxes[..., 0], boxes[..., 1], boxes[..., 3] / 2.0,
            boxes[..., 4] / 2.0, *_cos_sin(-boxes[..., 6])))

    def inside(frame, px, py):
        cx, cy, hx, hy, cos_, sin_ = frame
        dx = px - cx
        dy = py - cy
        rx = dx * cos_ - dy * sin_
        ry = dx * sin_ + dy * cos_
        return (torch.abs(rx) < hx + _MARGIN) & (torch.abs(ry) < hy + _MARGIN)

    fa = box_frame(boxes_a, -1)
    fb = box_frame(boxes_b, -2)
    shape = cand_v[0].shape
    for k in range(4):
        for frame, (px, py) in ((fa, Bc(k)), (fb, A(k))):
            ins = inside(frame, px, py)
            cand_x.append(torch.where(ins, px.expand(shape), 0.0))
            cand_y.append(torch.where(ins, py.expand(shape), 0.0))
            cand_v.append(ins)

    xs = torch.stack(cand_x)  # (24, ..., N, M)
    ys = torch.stack(cand_y)
    vs = torch.stack(cand_v)
    cnt = vs.sum(0)
    cnt_safe = cnt.clamp(min=1).to(xs.dtype)
    cx0 = torch.where(vs, xs, 0.0).sum(0) / cnt_safe
    cy0 = torch.where(vs, ys, 0.0).sum(0) / cnt_safe
    ang = torch.atan2(ys - cy0, xs - cx0)
    ang = torch.where(vs, ang, torch.inf)
    order = torch.sort(ang, dim=0, stable=True).indices
    xs_s = torch.gather(xs, 0, order)
    ys_s = torch.gather(ys, 0, order)
    vs_s = torch.gather(vs, 0, order)

    x0, y0 = xs_s[0:1], ys_s[0:1]
    vx = torch.where(vs_s, xs_s, x0) - x0
    vy = torch.where(vs_s, ys_s, y0) - y0
    tri = vx[:-1] * vy[1:] - vx[1:] * vy[:-1]
    area = torch.abs(tri.sum(0)) / 2.0
    cap = torch.minimum(
        (boxes_a[..., 3] * boxes_a[..., 4]).unsqueeze(-1),
        (boxes_b[..., 3] * boxes_b[..., 4]).unsqueeze(-2),
    )
    return torch.where(cnt > 0, torch.minimum(area, cap), 0.0)


def boxes_overlap_bev(boxes_a, boxes_b):
    """(..., N, 7) x (..., M, 7) -> (..., N, M) rotated BEV overlap areas in
    float32 (``pdanet_tpu/ops/rotated_iou.py:300-318``).  Plain PyTorch on
    any device."""
    return _pair_overlap(boxes_a.float(), boxes_b.float())


def boxes_iou_bev(boxes_a, boxes_b):
    """(..., N, 7) x (..., M, 7) -> (..., N, M) rotated BEV IoU (plain)."""
    boxes_a = boxes_a.float()
    boxes_b = boxes_b.float()
    sa = (boxes_a[..., 3] * boxes_a[..., 4]).unsqueeze(-1)
    sb = (boxes_b[..., 3] * boxes_b[..., 4]).unsqueeze(-2)
    overlap = _pair_overlap(boxes_a, boxes_b)
    return overlap / torch.clamp(sa + sb - overlap, min=EPS)


def boxes_iou3d(boxes_a, boxes_b):
    """(..., N, 7) x (..., M, 7) -> (..., N, M) 3-D IoU: the float32 rotated
    BEV overlap times the height overlap (``iou3d_nms_utils.boxes_iou3d_gpu``,
    iou3d_nms_utils.py:48-81; ``pdanet_tpu/ops/rotated_iou.py:349-366``).
    Plain PyTorch on any device: the JAX package has no kernel for it."""
    a_hmax = (boxes_a[..., 2] + boxes_a[..., 5] / 2).unsqueeze(-1)
    a_hmin = (boxes_a[..., 2] - boxes_a[..., 5] / 2).unsqueeze(-1)
    b_hmax = (boxes_b[..., 2] + boxes_b[..., 5] / 2).unsqueeze(-2)
    b_hmin = (boxes_b[..., 2] - boxes_b[..., 5] / 2).unsqueeze(-2)
    overlaps_bev = _pair_overlap(boxes_a.float(), boxes_b.float())
    overlaps_h = torch.clamp(
        torch.minimum(a_hmax, b_hmax) - torch.maximum(a_hmin, b_hmin), min=0)
    overlaps_3d = overlaps_bev * overlaps_h
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]).unsqueeze(-1)
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]).unsqueeze(-2)
    return overlaps_3d / torch.clamp(vol_a + vol_b - overlaps_3d, min=1e-6)


def paired_boxes_iou3d(boxes_a, boxes_b):
    """Row-aligned 3-D IoU: (N, 7) x (N, 7) -> (N,), row i of ``boxes_a``
    against row i of ``boxes_b`` (``pdanet_tpu/ops/rotated_iou.py:369-376``,
    the reference's ``loss_utils.generate_iou3d``), each pair its own 1 x 1
    problem: no N x N matrix is built."""
    return boxes_iou3d(boxes_a[..., None, :], boxes_b[..., None, :])[..., 0, 0]


def boxes_iou_bev_batched_self(boxes):
    """(B, K, 7) -> (B, K, K) self-IoU, the NMS suppression matrix."""
    return rotated_iou_op(boxes)


PLAIN_PAIRS = 1 << 22  # pairs of the plain version at a time


def boxes_iou_bev_batched_self_plain(boxes):
    """The plain PyTorch version, a block of rows at a time (no pair
    depends on another; the clip's (24, rows, K) temporaries of all K^2
    pairs at once outgrow a host's memory at the proposal layer's K 9000)."""
    rows = max(1, PLAIN_PAIRS // max(boxes.shape[0] * boxes.shape[1], 1))
    return torch.cat([boxes_iou_bev(boxes[:, r:r + rows], boxes)
                      for r in range(0, boxes.shape[1], rows)], dim=1)


@cuda_lib.on_tensor_device
def boxes_iou_bev_batched_self_cuda(boxes):
    """The kernel: one CTA per 16 x 16 tile of pairs computes its 32 boxes'
    corners and trig once, writes 0 for the pairs its circle skip proves
    apart and clips the rest from a compacted queue."""
    if boxes.dim() != 3 or boxes.shape[2] != 7:
        raise ValueError(f"boxes_iou_bev_batched_self: want (B, K, 7), got {tuple(boxes.shape)}")
    if boxes.shape[0] > MAX_FRAMES:
        raise ValueError(f"boxes_iou_bev_batched_self: B {boxes.shape[0]} > {MAX_FRAMES} frames")
    cuda_lib.require_cuda("boxes_iou_bev_batched_self", boxes)
    B, K, _ = boxes.shape
    out = torch.empty((B, K, K), dtype=torch.float32, device=boxes.device)
    lib = cuda_lib.lib()
    code = lib.pdanet_iou_bev_self(
        cuda_lib.ptr(boxes), B, K, cuda_lib.ptr(out),
        cuda_lib.stream_handle(boxes.device))
    cuda_lib.check(code, "rotated_iou")
    cuda_lib.launches["rotated_iou"] += 1
    cuda_lib.launches_by_k[f"rotated_iou_k{K}"] += 1
    return out


@torch.library.custom_op(f"{cuda_lib.NAMESPACE}::rotated_iou", mutates_args=(),
                         device_types="cpu")
def rotated_iou_op(boxes: torch.Tensor) -> torch.Tensor:
    return boxes_iou_bev_batched_self_plain(boxes)


rotated_iou_op.register_kernel("cuda")(boxes_iou_bev_batched_self_cuda)


@rotated_iou_op.register_fake
def _(boxes):
    B, K = boxes.shape[:2]
    return boxes.new_empty((B, K, K), dtype=torch.float32)
