"""Rotated-box geometry on batched dense tensors.

Counterpart of ``pdanet_tpu/ops/geometry.py:33-130``:
``rotate_points_along_z``, ``boxes_to_corners_3d``, ``enlarge_box3d`` (and
its numpy twin ``enlarge_box3d_np``), ``in_box_mask``, ``points_in_boxes``
(the reference kernel's first-hit semantics, -1 for background) and
``mask_points_by_range`` (the last and ``enlarge_box3d_np`` are
``utils/box_utils.py``'s).  Plain tensor code, differentiable where the
JAX functions are.
"""

import torch

# the numpy ``enlarge_box3d`` of the data pipeline, and its x / y range
# mask, which takes a tensor on any device as well as a numpy array
from ..utils.box_utils import enlarge_box3d as enlarge_box3d_np  # noqa: F401
from ..utils.box_utils import mask_points_by_range  # noqa: F401

# corner order of pcdet/utils/box_utils.py:44-47
_CORNER_TEMPLATE = torch.tensor([
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
    [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
], dtype=torch.float32) / 2.0


def rotate_points_along_z(points, angle):
    """(..., N, 3 + C) points, (...,) radians -> rotated points: ``points
    @ [[cos, sin, 0], [-sin, cos, 0], [0, 0, 1]]`` (angle turns x to y)."""
    cosa, sina = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(cosa), torch.ones_like(cosa)
    rot = torch.stack([cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones],
                      dim=-1).reshape(angle.shape + (3, 3))
    xyz = torch.matmul(points[..., 0:3], rot)
    return torch.cat([xyz, points[..., 3:]], dim=-1)


def boxes_to_corners_3d(boxes3d):
    """(N, 7) [x, y, z, dx, dy, dz, heading] -> (N, 8, 3) corners."""
    template = _CORNER_TEMPLATE.to(boxes3d.device, boxes3d.dtype)
    corners = boxes3d[:, None, 3:6] * template[None]
    corners = rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def enlarge_box3d(boxes3d, extra_width=(0, 0, 0)):
    """Grow the box extents (columns 3:6) by ``extra_width``, centres fixed."""
    extra = torch.zeros(boxes3d.shape[-1], dtype=boxes3d.dtype, device=boxes3d.device)
    extra[3:6] = torch.tensor(extra_width, dtype=boxes3d.dtype)
    return boxes3d + extra


def in_box_mask(points, boxes, z_margin=0.0, xy_margin=1e-5):
    """(..., N, 3) points x (..., M, 7) boxes -> (..., N, M) bool.

    ``check_pt_in_box3d`` semantics: ``|z - cz| <= dz / 2`` with no margin;
    in the box plane a strict ``<`` against half extents plus 1e-5.
    """
    d = points[..., :, None, :] - boxes[..., None, :, 0:3]  # (..., N, M, 3)
    rz = boxes[..., None, :, 6]
    cosa, sina = torch.cos(rz), torch.sin(rz)
    local_x = d[..., 0] * cosa + d[..., 1] * sina
    local_y = -d[..., 0] * sina + d[..., 1] * cosa
    in_z = torch.abs(d[..., 2]) <= boxes[..., None, :, 5] / 2.0 + z_margin
    in_xy = ((torch.abs(local_x) < boxes[..., None, :, 3] / 2.0 + xy_margin)
             & (torch.abs(local_y) < boxes[..., None, :, 4] / 2.0 + xy_margin))
    return in_z & in_xy


def points_in_boxes(points, boxes):
    """First box (in scan order, zero-padded rows included) holding each
    point: (..., N, 3) x (..., M, 7) -> (..., N) int64, -1 for none."""
    inside = in_box_mask(points, boxes)
    first = torch.argmax(inside.to(torch.uint8), dim=-1)  # first True
    return torch.where(inside.any(dim=-1), first, -1)
