"""The Part-A2 RoI head (PartA2FCHead): counterpart of
``pdanet_tpu/models/roi_heads/partA2_head.py``
(``pcdet/models/roi_heads/partA2_head.py``).

Each RoI pools the voxels inside it into a POOL_SIZE^3 grid
(``ops/roi_pool.roiaware_pool3d``): the part features (the sigmoided part
offsets, zeroed below ``SEG_MASK_SCORE_THRESH`` of the segmentation score,
or with ``DISABLE_PART`` the voxel centres themselves, beside the score)
by their mean, the UNet's segmentation features by their max.  A cell is
occupied where any pooled part feature is nonzero.  Two 3x3x3 conv blocks
a branch (``conv_part_a`` / ``_b``, ``conv_rpn_a`` / ``_b``: the dense form
of the reference's submanifold convs, each re-masked to the occupied
cells; BatchNorm over every cell of every RoI at eps 1e-3, flax momentum
0.99) run on the (B * R, C, g, g, g) grids; their concat, flattened
channels last, goes through ``RefineStacks``' shared, cls and reg FC stacks.

Module names are the flax ones (``conv_part_a.Conv_0``,
``conv_part_a.BatchNorm_0``, ``shared_fc0`` ... ``reg_pred``).
"""

import torch

from ...ops.roi_pool import roiaware_pool3d
from ...utils.easydict import EasyDict
from ..backbones_3d.voxel_backbone import Conv3DBNReLU
from .roi_head_template import RefineStacks


class MaskedConvBlock(Conv3DBNReLU):
    """conv 3x3x3 (no bias) + BatchNorm (eps 1e-3) + ReLU, times the
    occupancy (JAX :24-36): a (N, C, g, g, g) grid and its (N, 1, g, g, g)
    occupancy."""

    def forward(self, x, occ):
        return super().forward(x, None) * occ


class PartA2HeadNet(RefineStacks):
    """RoI-aware pooling and refinement (JAX :39-133) over the UNet's
    ``seg_channels``-wide voxel features."""

    def __init__(self, model_cfg, seg_channels, code_size, num_class=1):
        super().__init__()
        cfg = EasyDict(model_cfg)
        pool_cfg = EasyDict(cfg.ROI_AWARE_POOL)
        self.grid = int(pool_cfg.POOL_SIZE)
        c0 = int(pool_cfg.NUM_FEATURES) // 2
        self.disable_part = bool(cfg.get("DISABLE_PART", False))
        self.thresh = float(cfg.get("SEG_MASK_SCORE_THRESH", 0.3))
        self.conv_part_a = MaskedConvBlock(4, 64)
        self.conv_part_b = MaskedConvBlock(64, c0)
        self.conv_rpn_a = MaskedConvBlock(int(seg_channels), 64)
        self.conv_rpn_b = MaskedConvBlock(64, c0)
        self.build_stacks(cfg, self.grid ** 3 * 2 * c0, code_size, num_class)

    def pool(self, point_coords, seg_features, part_offsets, seg_scores, point_valid, rois):
        """The (B * R, C, g, g, g) grids of the part features (mean) and the
        segmentation features (max)."""
        part_src = point_coords if self.disable_part else part_offsets
        masked = torch.where(seg_scores[..., None] < self.thresh, 0.0, part_src)
        # a float64 model's centres are float32, as the JAX package's
        dt = torch.promote_types(masked.dtype, seg_scores.dtype)
        part_feats = torch.cat([masked.to(dt), seg_scores[..., None].to(dt)], dim=-1)
        g = (self.grid,) * 3
        pooled_part = roiaware_pool3d(rois, point_coords, part_feats, g, "avg", point_valid)
        pooled_rpn = roiaware_pool3d(rois, point_coords, seg_features, g, "max", point_valid)
        grids = lambda p: p.flatten(0, 1).permute(0, 4, 1, 2, 3)  # noqa: E731
        return grids(pooled_part), grids(pooled_rpn)

    def forward(self, point_coords, seg_features, part_offsets, seg_scores, point_valid, rois,
                keep=None):
        """point_coords (B, V, 3) voxel centres, seg_features (B, V, C),
        part_offsets (B, V, 3) sigmoided, seg_scores (B, V), point_valid (B,
        V), rois (B, R, 7); ``keep`` in training with ``DP_RATIO`` ->
        ``rcnn_cls`` (B, R, num_class), ``rcnn_reg`` (B, R, code_size *
        num_class)."""
        part, rpn = self.pool(point_coords, seg_features, part_offsets, seg_scores,
                              point_valid, rois)
        return self.refine_pooled(part, rpn, rois.shape[1], keep)

    def refine_pooled(self, part, rpn, rois_per_frame, keep=None):
        """The pooled (B * R, C, g, g, g) grids through the masked convs and
        the FC stacks -> ``(rcnn_cls, rcnn_reg)``."""
        occ = (part != 0).any(dim=1, keepdim=True).to(part.dtype)
        x_part = self.conv_part_b(self.conv_part_a(part, occ), occ)
        x_rpn = self.conv_rpn_b(self.conv_rpn_a(rpn, occ), occ)
        merged = torch.cat([x_rpn, x_part], dim=1).permute(0, 2, 3, 4, 1)
        return self.refine(merged.reshape(-1, rois_per_frame, merged[0].numel()), keep)
