"""PointRCNN's RoI head: counterpart of
``pdanet_tpu/models/roi_heads/pointrcnn_head.py``
(``pcdet/models/roi_heads/pointrcnn_head.py``).

Each RoI (widened by ``POOL_EXTRA_WIDTH``) pools the first
``NUM_SAMPLED_POINTS`` points inside it (``ops/roi_pool.roipoint_pool3d``)
with [the point's foreground score | its depth | its backbone features];
the pooled xyz go into the canonical frame of the original RoI, and an
empty RoI's cloud is zeros.  [local xyz | score | depth] goes up through
``xyz_up``, beside the features, and down through ``merge_down``; then
the SA stages (a single-scale PointNet++ SA layer each, the last one
``npoint = -1``: everything into one token, raw xyz without centring)
run on the (B * R, K) clouds folded into the batch, so that FPS and the
ball query run over B * R frames at once; the token goes through the cls
and reg FC stacks.

``USE_BN`` sets the BatchNorm of ``xyz_up`` / ``merge_down`` alone: the
SA stages are batch-normed whatever it says, as the reference's vanilla SA
layer ignores the flag (JAX :141-151).  The cls / reg stacks are Dense
without bias + BatchNorm + ReLU (``{prefix}_fc{k}``, ``{prefix}_bn{k}``),
dropout after their first layer in training, its keep masks a value
(:meth:`dropout_shapes`, ``roi_head_template.frame_draws``), and a biased
``{prefix}_out`` drawn from normal(0.001).  Module names are the flax ones.
"""

import torch
from torch import nn

from ...ops.ball_query import ball_query
from ...ops.geometry import rotate_points_along_z
from ...ops.grouping import gather_points, group_points
from ...ops.roi_pool import roipoint_pool3d
from ...ops.sampling import farthest_point_sample
from ...utils.easydict import EasyDict
from ..blocks import BatchNorm, Dense
from .roi_head_template import dropout

BALL_QUERY_SITE = "roi"  # the SA stages' ball-query launches: ``ball_query_roi``


class _MLP(nn.Module):
    """Dense + ReLU layers ``fc{k}``, with a BatchNorm ``bn{k}`` (and no
    bias) under ``use_bn`` (JAX :30-46)."""

    def __init__(self, in_features, widths, use_bn=False):
        super().__init__()
        self.n, self.use_bn = len(widths), bool(use_bn)
        c = int(in_features)
        for k, f in enumerate(widths):
            self.add_module(f"fc{k}", Dense(c, int(f), bias=not self.use_bn))
            if self.use_bn:
                self.add_module(f"bn{k}", BatchNorm(int(f)))
            c = int(f)

    def forward(self, x):
        for k in range(self.n):
            x = getattr(self, f"fc{k}")(x)
            if self.use_bn:
                x = getattr(self, f"bn{k}")(x)
            x = torch.relu(x)
        return x


class SAStage(nn.Module):
    """Single-scale PointnetSAModule (JAX :49-75): FPS, the ball query, the
    batch-normed ``mlp`` over [relative xyz | features], a max over the
    neighbours (to the first maximum); ``npoint = -1`` groups everything,
    the raw xyz uncentred, into one token at a zero centre."""

    def __init__(self, npoint, radius, nsample, in_features, mlp):
        super().__init__()
        self.npoint, self.radius, self.nsample = int(npoint), float(radius), int(nsample)
        self.mlp = _MLP(int(in_features) + 3, [int(f) for f in mlp], use_bn=True)

    def forward(self, xyz, features):
        if self.npoint > 0:
            new_xyz = gather_points(xyz, farthest_point_sample(xyz.contiguous(), self.npoint))
            idx = ball_query(self.radius, self.nsample, xyz, new_xyz, BALL_QUERY_SITE)
            grouped = torch.cat([group_points(xyz, idx) - new_xyz[:, :, None, :],
                                 group_points(features, idx)], dim=-1)
        else:
            new_xyz = torch.zeros_like(xyz[:, :1, :])
            grouped = torch.cat([xyz, features], dim=-1)[:, None]
        return new_xyz, self.mlp(grouped).max(dim=2).values


class PointRCNNHeadNet(nn.Module):
    """RoI point pooling and refinement (JAX :78-176) over backbone features
    of ``in_features`` channels."""

    def __init__(self, model_cfg, in_features, code_size, num_class=1):
        super().__init__()
        cfg = EasyDict(model_cfg)
        pool_cfg = EasyDict(cfg.ROI_POINT_POOL)
        self.num_sampled = int(pool_cfg.NUM_SAMPLED_POINTS)
        self.depth_normalizer = float(pool_cfg.DEPTH_NORMALIZER)
        self.extra_width = [float(w) for w in pool_cfg.get("POOL_EXTRA_WIDTH", (0, 0, 0))]
        use_bn = bool(cfg.get("USE_BN", False))
        up = [int(f) for f in cfg.XYZ_UP_LAYER]
        self.xyz_up = _MLP(5, up, use_bn)
        self.merge_down = _MLP(up[-1] + int(in_features), [up[-1]], use_bn)
        sa = EasyDict(cfg.SA_CONFIG)
        self.n_sa = len(sa.NPOINTS)
        c = up[-1]
        for i in range(self.n_sa):
            self.add_module(f"SA_{i}", SAStage(sa.NPOINTS[i], sa.RADIUS[i], sa.NSAMPLE[i], c,
                                               sa.MLPS[i]))
            c = int(sa.MLPS[i][-1])
        self.dp = float(cfg.get("DP_RATIO", 0.0))
        self.stacks = {"cls": ([int(f) for f in cfg.CLS_FC], int(num_class)),
                       "reg": ([int(f) for f in cfg.REG_FC], int(code_size) * int(num_class))}
        for prefix, (widths, n_out) in self.stacks.items():
            w = c
            for k, f in enumerate(widths):
                self.add_module(f"{prefix}_fc{k}", Dense(w, f, bias=False))
                self.add_module(f"{prefix}_bn{k}", BatchNorm(f))
                w = f
            out = Dense(w, n_out)
            with torch.no_grad():  # flax's normal(0.001), zero bias
                out.weight.normal_(0.0, 0.001)
                out.bias.zero_()
            self.add_module(f"{prefix}_out", out)

    def dropout_shapes(self, rois_per_frame):
        """``{name: (R, C)}``: the keep mask a frame that each dropout takes,
        after the first layer of the cls and of the reg stack (``cls0``,
        ``reg0``); none without ``DP_RATIO``."""
        if self.dp <= 0:
            return {}
        return {f"{prefix}0": (rois_per_frame, widths[0])
                for prefix, (widths, _) in self.stacks.items() if widths}

    def _stack(self, x, prefix, keep):
        for k in range(len(self.stacks[prefix][0])):
            x = torch.relu(getattr(self, f"{prefix}_bn{k}")(getattr(self, f"{prefix}_fc{k}")(x)))
            if k == 0 and self.dp > 0 and self.training:
                x = dropout(x, keep, f"{prefix}0", self.dp)
        return getattr(self, f"{prefix}_out")(x)

    def pool(self, point_coords, point_features, point_scores, rois):
        """The (B, R, K, 5 + C) canonical clouds ``[local xyz | score | depth |
        features]``, zeros for an empty RoI."""
        B, R = rois.shape[:2]
        K = self.num_sampled
        # the quotient by the normalizer as XLA compiles it: a product with
        # its reciprocal in the coordinates' dtype
        recip = torch.reciprocal(torch.tensor(self.depth_normalizer, dtype=point_coords.dtype))
        depth = torch.linalg.norm(point_coords, dim=-1) * recip.to(point_coords.device) - 0.5
        feats = torch.cat([point_scores[..., None], depth[..., None], point_features], dim=-1)
        extra = torch.tensor(self.extra_width, dtype=rois.dtype, device=rois.device)
        pool_rois = torch.cat([rois[..., 0:3], rois[..., 3:6] + extra, rois[..., 6:7]], dim=-1)
        pooled, empty = roipoint_pool3d(pool_rois, point_coords, feats, K)
        local = rotate_points_along_z((pooled[..., 0:3] - rois[:, :, None, 0:3]).reshape(
            B * R, K, 3), -rois[..., 6].reshape(B * R)).reshape(B, R, K, 3)
        pooled = torch.cat([local, pooled[..., 3:]], dim=-1)
        return torch.where(empty[..., None, None], 0.0, pooled)

    def forward(self, point_coords, point_features, point_scores, rois, keep=None):
        """point_coords (B, N, 3), point_features (B, N, C), point_scores (B,
        N) sigmoid foreground scores, rois (B, R, 7); ``keep`` in training
        with ``DP_RATIO`` -> ``rcnn_cls`` (B, R, num_class), ``rcnn_reg`` (B,
        R, code_size * num_class)."""
        return self.refine_pooled(self.pool(point_coords, point_features, point_scores, rois),
                                  keep)

    def refine_pooled(self, pooled, keep=None):
        """The (B, R, K, 5 + C) pooled clouds (:meth:`pool`) through
        ``xyz_up`` / ``merge_down``, the SA stages and the FC stacks ->
        ``(rcnn_cls, rcnn_reg)``."""
        if self.training and self.dp > 0 and keep is None:
            raise ValueError("PointRCNNHeadNet: training with DP_RATIO takes the dropout keep "
                             "masks (train.make_train_step draws them)")
        B, R, K = pooled.shape[:3]
        flat = pooled.reshape(B * R, K, -1)
        merged = self.merge_down(torch.cat([self.xyz_up(flat[..., 0:5]), flat[..., 5:]], dim=-1))
        xyz, feats = flat[..., 0:3], merged
        for i in range(self.n_sa):
            xyz, feats = getattr(self, f"SA_{i}")(xyz, feats)
        shared = feats[:, 0, :].reshape(B, R, -1)
        return self._stack(shared, "cls", keep), self._stack(shared, "reg", keep)
