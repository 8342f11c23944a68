"""Mean VFE: counterpart of ``pdanet_tpu/models/backbones_3d/vfe/
mean_vfe.py`` (``pcdet/models/backbones_3d/vfe/mean_vfe.py``): each voxel's
feature is the mean of its points."""

from torch import nn


class MeanVFE(nn.Module):
    """No parameters; ``num_point_features`` in, the same out."""

    def __init__(self, model_cfg=None, num_point_features=4):
        super().__init__()
        self.num_point_features = num_point_features

    def forward(self, voxels, voxel_num_points):
        """voxels (B, V, P, C), padded points zero; voxel_num_points (B, V)
        -> (B, V, C), an empty slot's zeros over a count clamped to 1."""
        counts = voxel_num_points.clamp(min=1).to(voxels.dtype)
        return voxels.sum(dim=2) / counts[..., None]
