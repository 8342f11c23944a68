"""Camera and depth transforms: counterpart of ``pdanet_tpu/utils/
transform_utils.py`` (``pcdet/utils/transform_utils.py``), CaDDN's support.

The quotients by constants are products with the folded reciprocal, as
the JAX package's jitted XLA computes them (``centernet_utils.div_const``).
"""

import math

import torch

from ..models.model_utils.centernet_utils import div_const


def project_to_image(project, points):
    """(..., 3, 4) camera matrix, (..., N, 3) points -> pixel coordinates
    (..., N, 2) and depths (..., N)."""
    homo = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    pt = torch.einsum("...ij,...nj->...ni", project, homo)
    z = pt[..., 2:3]
    points_img = pt[..., :2] / torch.where(z.abs() > 1e-8, z, 1e-8)
    return points_img, pt[..., 2] - project[..., 2:3, 3]


def normalize_coords(coords, shape):
    """Grid coordinates in [0, shape - 1] -> [-1, 1], the align_corners=True
    formula (reference :38-53; the sampler then reads them with
    ``grid_sample``'s align_corners=False, a reference quirk kept).
    coords (..., 3) in (u, v, d) order; shape (d, h, w)."""
    rev = [float(s) - 1.0 for s in reversed(shape)]  # (w, h, d) - 1
    inv = torch.reciprocal(torch.tensor(rev, dtype=coords.dtype)).to(coords.device)
    return coords * inv * 2.0 - 1.0


def bin_depths(depth_map, mode, depth_min, depth_max, num_bins, target=False):
    """Depth -> bin index (reference :56-95), ``UD``, ``LID`` or ``SID``;
    with ``target`` the int64 index, ``num_bins`` where out of range or not
    finite."""
    if mode == "UD":
        bin_size = (depth_max - depth_min) / num_bins
        indices = div_const(depth_map - depth_min, bin_size)
    elif mode == "LID":
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        indices = -0.5 + 0.5 * torch.sqrt(torch.clamp(
            1 + div_const(8 * (depth_map - depth_min), bin_size), min=0.0))
    elif mode == "SID":
        indices = div_const(torch.log(1 + depth_map) - math.log(1 + depth_min),
                            math.log(1 + depth_max) - math.log(1 + depth_min),
                            times=num_bins)
    else:
        raise ValueError(f"depth binning {mode}: UD, LID or SID")
    if target:
        bad = (indices < 0) | (indices > num_bins) | ~torch.isfinite(indices)
        indices = torch.where(bad, num_bins, indices).to(torch.int64)
    return indices


def compute_fg_mask(gt_boxes2d, shape, downsample_factor=1):
    """The foreground pixels of the padded (B, M, 4) [u1 v1 u2 v2] 2-D boxes
    (reference ``loss_utils.compute_fg_mask``, :366-390) on a (B, H, W)
    map at 1 / ``downsample_factor`` of the image -> (B, H, W) bool."""
    B, H, W = shape
    boxes = div_const(gt_boxes2d, float(downsample_factor))
    valid = (gt_boxes2d != 0).any(dim=-1)
    u1, v1 = torch.floor(boxes[..., 0]), torch.floor(boxes[..., 1])
    u2, v2 = torch.ceil(boxes[..., 2]), torch.ceil(boxes[..., 3])
    us = torch.arange(W, dtype=boxes.dtype, device=boxes.device)
    vs = torch.arange(H, dtype=boxes.dtype, device=boxes.device)
    in_u = (us >= u1[..., None]) & (us < u2[..., None])  # (B, M, W)
    in_v = (vs >= v1[..., None]) & (vs < v2[..., None])  # (B, M, H)
    per_box = in_v[:, :, :, None] & in_u[:, :, None, :] & valid[:, :, None, None]
    return per_box.any(dim=1)
