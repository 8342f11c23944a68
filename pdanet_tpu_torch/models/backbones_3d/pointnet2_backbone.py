"""PointNet++ MSG backbone with its FP decoder (channels-last): counterpart
of ``pdanet_tpu/models/backbones_3d/pointnet2_backbone.py``
(``pcdet/models/backbones_3d/pointnet2_backbone.py``, PointNet2MSG, the
PointRCNN backbone).

* ``PointnetSAModuleMSG`` (JAX :21-49): D-FPS, the multi-radius ball query
  (one op for every radius), and a Dense + BatchNorm + ReLU stack a scale
  over [the neighbours' xyz relative to their centre | their features],
  max-pooled over the K neighbours.  The max is
  ``Tensor.max(dim).values``, whose gradient goes to the first maximal
  slot, as the JAX package's ``max_first``: the ball query's first-hit
  padding makes exact ties common.
* ``PointnetFPModule`` (:52-72): each fine point's three nearest coarse
  points (``three_nn``), their inverse-distance weights ``1 / (sqrt(max(d2,
  0)) + 1e-8)`` normalised, the weighted coarse features
  (``three_interpolate``) beside the fine level's own, through a stack.
* ``PointNet2MSG`` (:75-123): the SA levels down ``NPOINTS``, then the FP
  modules back up to the input points.

Module names are the flax ones (``SA_modules_{k}.mlps_{i}.layer{j}``,
``FP_modules_{i}.mlp``), so that the weight bridge maps a JAX tree leaf
for leaf.  Only the index ops (FPS, the ball query, the three-NN search)
take detached inputs.
"""

import torch
from torch import nn

from ...ops.ball_query import ball_query_multi
from ...ops.grouping import gather_points, group_points
from ...ops.interpolate import three_interpolate, three_nn
from ...ops.sampling import farthest_point_sample
from ...utils.easydict import EasyDict
from ..blocks import MLPStack


class PointnetSAModuleMSG(nn.Module):
    """Vanilla multi-scale-grouping SA layer; ``mlps[i]`` is ``[c_in + 3,
    widths...]`` of scale i."""

    def __init__(self, npoint, radii, nsamples, mlps):
        super().__init__()
        self.npoint = int(npoint)
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(k) for k in nsamples)
        for i, m in enumerate(mlps):
            self.add_module(f"mlps_{i}", MLPStack(int(m[0]), [int(f) for f in m[1:]]))

    def forward(self, xyz, features):
        """xyz (B, N, 3), features (B, N, C) or None -> the centres (B,
        npoint, 3) and their features (B, npoint, sum of the scales' widths)."""
        new_xyz = gather_points(xyz, farthest_point_sample(xyz.contiguous(), self.npoint))
        idx_list = ball_query_multi(self.radii, self.nsamples, xyz, new_xyz)
        outs = []
        for i, idx in enumerate(idx_list):
            grouped = group_points(xyz, idx) - new_xyz[:, :, None, :]
            if features is not None:
                grouped = torch.cat([grouped, group_points(features, idx)], dim=-1)
            outs.append(getattr(self, f"mlps_{i}")(grouped).max(dim=2).values)
        return new_xyz, torch.cat(outs, dim=-1)


class PointnetFPModule(nn.Module):
    """Feature propagation: the coarse level's features interpolated onto
    the fine points, beside the fine level's own, through ``mlp``."""

    def __init__(self, in_features, mlp):
        super().__init__()
        self.mlp = MLPStack(int(in_features), [int(f) for f in mlp])

    def forward(self, unknown, known, unknown_feats, known_feats):
        dist2, idx = three_nn(unknown, known)
        dist_recip = 1.0 / (torch.sqrt(dist2.clamp(min=0.0)) + 1e-8)
        weight = dist_recip / dist_recip.sum(dim=2, keepdim=True)
        h = three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            h = torch.cat([h, unknown_feats], dim=-1)
        return self.mlp(h)


class PointNet2MSG(nn.Module):
    """model_cfg keys: ``SA_CONFIG.{NPOINTS, RADIUS, NSAMPLE, MLPS}``,
    ``FP_MLPS``; ``input_channels`` counts xyz."""

    def __init__(self, model_cfg, input_channels):
        super().__init__()
        cfg = EasyDict(model_cfg)
        sa = cfg.SA_CONFIG
        channel_in = int(input_channels) - 3
        skip = [channel_in]
        self.n_levels = len(sa.NPOINTS)
        for k in range(self.n_levels):
            mlps = [[channel_in + 3] + [int(f) for f in m] for m in sa.MLPS[k]]
            self.add_module(f"SA_modules_{k}", PointnetSAModuleMSG(
                sa.NPOINTS[k], sa.RADIUS[k], sa.NSAMPLE[k], mlps))
            channel_in = sum(m[-1] for m in mlps)
            skip.append(channel_in)
        fp = [[int(f) for f in m] for m in cfg.FP_MLPS]
        for i in range(len(fp) - 1, -1, -1):
            # the coarse input: the level above's FP output, or the deepest SA
            coarse = fp[i + 1][-1] if i + 1 < len(fp) else skip[i + 1]
            self.add_module(f"FP_modules_{i}", PointnetFPModule(coarse + skip[i], fp[i]))
        self.n_fp = len(fp)
        self.num_point_features = fp[0][-1]

    def forward(self, points):
        """points (B, N, 3 + C) -> ``point_features`` (B, N, FP_MLPS[0][-1])
        and ``point_coords`` (B, N, 3)."""
        xyz = points[..., 0:3]
        features = points[..., 3:] if points.shape[-1] > 3 else None
        l_xyz, l_features = [xyz], [features]
        for k in range(self.n_levels):
            new_xyz, new_feats = getattr(self, f"SA_modules_{k}")(l_xyz[-1], l_features[-1])
            l_xyz.append(new_xyz)
            l_features.append(new_feats)
        for i in range(self.n_fp - 1, -1, -1):
            l_features[i] = getattr(self, f"FP_modules_{i}")(
                l_xyz[i], l_xyz[i + 1], l_features[i], l_features[i + 1])
        return {"point_features": l_features[0], "point_coords": xyz}
