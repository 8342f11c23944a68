"""Pillar VFE: counterpart of ``pdanet_tpu/models/backbones_3d/vfe/
pillar_vfe.py`` (``pcdet/models/backbones_3d/vfe/pillar_vfe.py``).

A stack of PFN layers (Dense -> BatchNorm -> ReLU -> max over the points
of each pillar) over per-point features ``[xyz, intensity, cluster
offsets, centre offsets]``.  Dense layout: voxels (B, V, P, C) with a
point count per pillar; padded points are zeroed once, as the reference's
paddings indicator does.
"""

import torch
from torch import nn

from ....utils.easydict import EasyDict
from ...blocks import BatchNorm, Dense

BN_EPS, BN_MOMENTUM = 1e-3, 0.99  # flax momentum 0.99: torch's 0.01 (pillar_vfe.py:37-40)


class PFNLayer(nn.Module):
    """One PFN layer.  The reference's quirk stays (JAX ``pillar_vfe.py:
    18-25``): padded point rows are zeroed once, before the stack, so after
    Dense -> BatchNorm -> ReLU they carry ``relu(bn(dense(0)))``, and that
    "phantom" row takes part in the max of every pillar that is not full.
    No re-masking happens here; padded pillar slots are dropped later, by
    their coords, in the scatter.  The max is ``Tensor.max(dim)``, whose
    gradient goes to the first maximum (``max_first_keepdims``)."""

    def __init__(self, in_features, out_channels, use_norm=True, last_layer=False):
        super().__init__()
        self.last_layer = last_layer
        out = out_channels if last_layer else out_channels // 2
        self.linear = Dense(in_features, out, bias=not use_norm)
        self.norm = BatchNorm(out, eps=BN_EPS, momentum=BN_MOMENTUM) if use_norm else None

    def forward(self, x):
        h = self.linear(x)
        if self.norm is not None:
            h = self.norm(h)
        h = torch.relu(h)
        h_max = h.max(dim=2, keepdim=True).values  # (B, V, 1, C')
        if self.last_layer:
            return h_max
        return torch.cat([h, h_max.expand(h.shape)], dim=-1)


class PillarVFE(nn.Module):
    """model_cfg keys: USE_NORM, WITH_DISTANCE, USE_ABSLOTE_XYZ, NUM_FILTERS."""

    def __init__(self, model_cfg, num_point_features, voxel_size, point_cloud_range):
        super().__init__()
        cfg = EasyDict(model_cfg)
        self.use_absolute_xyz = cfg.get("USE_ABSLOTE_XYZ", True)
        self.with_distance = cfg.get("WITH_DISTANCE", False)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        vx, vy, vz = self.voxel_size
        self.offsets = (vx / 2 + point_cloud_range[0], vy / 2 + point_cloud_range[1],
                        vz / 2 + point_cloud_range[2])
        c_in = num_point_features + 6 if self.use_absolute_xyz else num_point_features + 3
        if self.with_distance:
            c_in += 1
        num_filters = list(cfg.NUM_FILTERS)
        self.n = len(num_filters)
        for i, nf in enumerate(num_filters):
            last = i >= self.n - 1
            self.add_module(f"pfn_layers_{i}", PFNLayer(c_in, nf, cfg.get("USE_NORM", True),
                                                        last))
            c_in = nf
        self.num_point_features = num_filters[-1]

    def forward(self, voxels, voxel_coords, voxel_num_points):
        """voxels (B, V, P, C_in); voxel_coords (B, V, 3) zyx (-1 pads);
        voxel_num_points (B, V).  Returns pillar features (B, V, C_out)."""
        counts = torch.clamp(voxel_num_points, min=1).to(voxels.dtype)
        points_mean = voxels[..., :3].sum(dim=2, keepdim=True) / counts[..., None, None]
        f_cluster = voxels[..., :3] - points_mean
        f_center = torch.stack([
            voxels[..., axis] - (voxel_coords[..., 2 - axis, None].to(voxels.dtype) * size + off)
            for axis, (size, off) in enumerate(zip(self.voxel_size, self.offsets))], dim=-1)
        feats = [voxels if self.use_absolute_xyz else voxels[..., 3:], f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(voxels[..., :3], dim=-1, keepdim=True))
        features = torch.cat(feats, dim=-1)
        P = voxels.shape[2]
        mask = torch.arange(P, device=voxels.device) < voxel_num_points[..., None]
        features = features * mask[..., None].to(features.dtype)
        for i in range(self.n):
            features = getattr(self, f"pfn_layers_{i}")(features)
        return features[:, :, 0, :]
