"""Dynamic pillar VFE: counterpart of ``pdanet_tpu/models/backbones_3d/vfe/
dynamic_pillar_vfe.py`` (``pcdet/models/backbones_3d/vfe/
dynamic_pillar_vfe.py``): pillar features over ALL the points of each
pillar (no per-pillar cap), the PFN stacks pooled by a scatter-max onto
the (ny * nx) BEV canvas and read back per point.

Per-point work stays dense (B, N, ...).  The pillar means of xyz are the
sorted-segment means of ``ops/roi_pool.segment_mean``; the max is one
``scatter_reduce`` (a tie splits its gradient evenly among the tied
points, as JAX's scatter-max does), the points outside the grid masked to
-inf, an empty pillar 0.  As in the JAX package, a point outside the grid
reads the last cell's mean and max back (its index clipped to the last
cell), and the BatchNorms normalize over every point of the batch.
Parameter names are the flax ones (``pfn0_linear``, ``pfn0_bn``).
"""

import torch
from torch import nn

from ....utils.easydict import EasyDict
from ...blocks import BatchNorm, Dense
from ....ops.roi_pool import segment_mean
from .dynamic_mean_vfe import grid_cells


def _read_back(pooled, flat, n_cells):
    """The (B, N, C) rows of the (B, cells + 1, C) ``pooled`` at each
    point's cell, the drop slot clipped to the last cell."""
    idx = flat.clamp(max=n_cells - 1)
    return torch.gather(pooled, 1, idx[..., None].expand(idx.shape + (pooled.shape[-1],)))


class DynamicPillarVFE(nn.Module):
    """The raw (B, N, 3 + C) cloud -> the BEV canvas (B, ny, nx, C_out).
    model_cfg keys: USE_ABSLOTE_XYZ, WITH_DISTANCE, NUM_FILTERS."""

    def __init__(self, model_cfg, num_point_features, grid_size, voxel_size,
                 point_cloud_range):
        super().__init__()
        cfg = EasyDict(model_cfg)
        self.use_absolute_xyz = bool(cfg.get("USE_ABSLOTE_XYZ", True))
        self.with_distance = bool(cfg.get("WITH_DISTANCE", False))
        self.grid_size = tuple(int(g) for g in grid_size)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.num_filters = [int(f) for f in cfg.NUM_FILTERS]
        c_in = num_point_features + 6 if self.use_absolute_xyz else num_point_features + 3
        c_in += int(self.with_distance)
        for i, width in enumerate(self.num_filters):
            self.add_module(f"pfn{i}_linear", Dense(c_in, width, bias=False))
            self.add_module(f"pfn{i}_bn", BatchNorm(width, eps=1e-3, momentum=0.99))
            c_in = 2 * width
        self.num_point_features = self.num_filters[-1]

    def forward(self, points):
        B, N, _ = points.shape
        nx, ny, _ = self.grid_size
        n_cells = ny * nx
        xyz = points[..., 0:3]
        flat, inside, coords = grid_cells(xyz[..., 0:2], self.grid_size, self.voxel_size,
                                          self.point_cloud_range)
        f_cluster = xyz - _read_back(segment_mean(flat, xyz, n_cells), flat, n_cells)
        # the pillar centres (c + 0.5) * vs + origin in float32, each step
        # rounded (the JAX package's XLA does not fuse them here)
        vs = torch.tensor(self.voxel_size[:2], dtype=torch.float32, device=points.device)
        origin = torch.tensor(self.point_cloud_range[:2], dtype=torch.float32,
                              device=points.device)
        centers = ((coords.float() + 0.5) * vs + origin).to(points.dtype)
        z_offset = self.voxel_size[2] / 2.0 + self.point_cloud_range[2]
        f_center = torch.cat([xyz[..., 0:2] - centers, xyz[..., 2:3] - z_offset], dim=-1)
        feats = [points if self.use_absolute_xyz else points[..., 3:], f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        h = torch.cat(feats, dim=-1)
        batch = torch.arange(B, device=points.device)[:, None] * (n_cells + 1)
        rows = (flat + batch).reshape(-1, 1)
        for i, width in enumerate(self.num_filters):
            h = getattr(self, f"pfn{i}_bn")(getattr(self, f"pfn{i}_linear")(h))
            h = torch.relu(h)
            masked = torch.where(inside[..., None], h, -torch.inf).reshape(-1, width)
            pooled = h.new_full((B * (n_cells + 1), width), -torch.inf).scatter_reduce(
                0, rows.expand(-1, width), masked, "amax", include_self=True)
            pooled = torch.where(torch.isfinite(pooled), pooled, 0.0).view(B, n_cells + 1, width)
            if i == len(self.num_filters) - 1:
                return pooled[:, :n_cells].reshape(B, ny, nx, width)
            h = torch.cat([h, _read_back(pooled, flat, n_cells)], dim=-1)
