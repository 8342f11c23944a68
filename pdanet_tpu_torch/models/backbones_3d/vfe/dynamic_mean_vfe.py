"""Dynamic mean VFE: counterpart of ``pdanet_tpu/models/backbones_3d/vfe/
dynamic_mean_vfe.py`` (``pcdet/models/backbones_3d/vfe/dynamic_mean_vfe.py``):
the mean of ALL the points of each voxel, no per-voxel point cap and no
voxel budget, written straight into the dense (B, Z, Y, X, C) grid that
the dense 3-D backbones take.  A point outside the grid goes to a drop
slot past the last cell.

The means are sorted-segment sums (``ops/roi_pool.segment_mean``, the
RoI-aware mean pool's), no atomics, so that a run gives the same bits
each time.
"""

import math

import torch
from torch import nn

from ....ops.roi_pool import segment_mean

_CELL_LIMIT = float(1 << 30)


def grid_cells(xyz, grid_size, voxel_size, point_cloud_range):
    """(B, N, k) coordinates -> (cell index a point, inside) over the first
    k axes of the grid: ``floor((x - origin) / voxel)`` as the JAX
    package's jitted XLA computes it, a product with the reciprocal of the
    float32 voxel size in the points' dtype (a quotient by a constant is
    compiled so; a point on a cell border falls alike), flat x-fastest,
    ``prod(grid)``
    where outside; also the inside mask and the (B, N, k) int64 cells."""
    k = xyz.shape[-1]
    dev = xyz.device
    dt = xyz.dtype
    inv = torch.reciprocal(torch.tensor(voxel_size[:k], dtype=torch.float32).to(dt)).to(dev)
    origin = torch.tensor(point_cloud_range[:k], dtype=torch.float32).to(dev, dt)
    grid = torch.tensor([int(g) for g in grid_size[:k]], device=dev)
    # clamped far outside every grid before the cast, which is then
    # defined for a far or non-finite coordinate on every device
    coords = torch.floor((xyz - origin) * inv).clamp(-_CELL_LIMIT, _CELL_LIMIT).to(torch.int64)
    inside = ((coords >= 0) & (coords < grid)).all(dim=-1)
    flat = torch.zeros_like(coords[..., 0])
    for axis in reversed(range(k)):
        flat = flat * int(grid_size[axis]) + coords[..., axis]
    return torch.where(inside, flat, math.prod(int(g) for g in grid_size[:k])), inside, coords


class DynamicMeanVFE(nn.Module):
    """No parameters: the raw (B, N, 3 + C) cloud -> the dense mean grid
    (B, Z, Y, X, 3 + C)."""

    def __init__(self, model_cfg, num_point_features, grid_size, voxel_size,
                 point_cloud_range):
        super().__init__()
        self.num_point_features = num_point_features
        self.grid_size = tuple(int(g) for g in grid_size)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)

    def forward(self, points):
        B, N, C = points.shape
        nx, ny, nz = self.grid_size
        flat, _, _ = grid_cells(points[..., 0:3], self.grid_size, self.voxel_size,
                                self.point_cloud_range)
        mean = segment_mean(flat, points, nz * ny * nx)
        return mean[:, :-1].reshape(B, nz, ny, nx, C)
