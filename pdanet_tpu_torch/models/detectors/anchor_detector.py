"""What the port's anchor-head detectors share (PointPillar, SECOND): the
anchors of the static grid, the single or multi-group anchor head over the
BEV map, the box decode, the axis-aligned or ATSS assigner and the loss
(JAX ``detectors/pointpillar.py`` and ``detectors/second.py``, which each
hold a copy).

A subclass builds its feature extractor, then calls :meth:`build_head`
with the BEV map's channel count, and its ``forward`` ends in
:meth:`head_forward`.
"""

import numpy as np
import torch
from torch import nn

from ...utils.box_coder_utils import build_box_coder
from ...utils.easydict import EasyDict
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..dense_heads import anchor_head as AH
from ..dense_heads import anchor_head_multi as AHM
from ..dense_heads.atss_assigner import atss_assign_targets

ASSIGNERS = ("AxisAlignedTargetAssigner", "ATSS")


class AnchorDetector(nn.Module):
    """``grid_size`` (nx, ny, nz), ``voxel_size``, ``point_cloud_range``
    and ``class_names`` come from the dataset (``build_network(...,
    dataset=...)``)."""

    DEVICE_BATCH_KEYS = ("voxels", "voxel_coords", "voxel_num_points", "gt_boxes")

    def __init__(self, model_cfg, num_class, grid_size, voxel_size, point_cloud_range,
                 class_names):
        super().__init__()
        if grid_size is None or voxel_size is None or point_cloud_range is None \
                or class_names is None:
            raise ValueError(f"{type(self).__name__} takes its grid from the dataset: "
                             "build_network(..., dataset=...)")
        self.cfg = EasyDict(model_cfg)
        self.num_class = num_class
        self.grid_size = tuple(int(g) for g in grid_size)
        self.point_cloud_range = point_cloud_range
        self.class_names = list(class_names)
        ta_cfg = self.cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG
        if ta_cfg.get("NAME", "AxisAlignedTargetAssigner") not in ASSIGNERS:
            raise ValueError(f"target assigner {ta_cfg.NAME}: the JAX package has "
                             f"{' and '.join(ASSIGNERS)}")

    def build_head(self, bev_channels):
        """The BEV backbone over ``bev_channels`` and the anchor head: the
        single head, or ``AnchorHeadMulti``'s groups (JAX ``second.py:
        108-125``), whose flat anchors are head-major."""
        head_cfg = self.cfg.DENSE_HEAD
        head_name = head_cfg.get("NAME", "AnchorHeadSingle")
        if head_name not in ("AnchorHeadSingle", "AnchorHeadMulti"):
            raise ValueError(f"dense head {head_name}: the JAX package's anchor detectors "
                             f"have AnchorHeadSingle and AnchorHeadMulti")
        self.backbone_2d = BaseBEVBackbone(self.cfg.BACKBONE_2D, bev_channels)
        anchors, num_per_loc = AH.generate_anchors(head_cfg.ANCHOR_GENERATOR_CONFIG,
                                                   self.grid_size, self.point_cloud_range)
        flat, per_class = AH.flat_anchors_per_class(anchors)
        self.box_coder = build_box_coder(head_cfg.TARGET_ASSIGNER_CONFIG.BOX_CODER, {})
        self.head_groups = None
        if head_name == "AnchorHeadMulti":
            names = [c["class_name"] for c in head_cfg.ANCHOR_GENERATOR_CONFIG]
            self.head_groups = AHM.build_head_groups(head_cfg.RPN_HEAD_CFGS, names)
            flat, self.head_anchor_counts = AHM.multihead_flat_anchors(per_class,
                                                                       self.head_groups)
            self.dense_head = AHM.AnchorHeadMultiNet(
                head_cfg, self.backbone_2d.num_bev_features, self.head_groups, num_per_loc,
                self.box_coder.code_size, self.num_class)
        else:
            self.dense_head = AH.AnchorHeadSingleNet(
                self.backbone_2d.num_bev_features, self.num_class, sum(num_per_loc),
                self.box_coder.code_size, head_cfg.get("USE_DIRECTION_CLASSIFIER", True),
                head_cfg.get("NUM_DIR_BINS", 2))
        # constants of the grid, float32 whatever the model's dtype (they
        # are read back to float32 at use): not in the state dict, and
        # contiguous, as NCCL's broadcast of the module's buffers wants them
        self.register_buffer("anchors_flat", torch.from_numpy(np.ascontiguousarray(flat)),
                             persistent=False)
        for i, a in enumerate(per_class):
            self.register_buffer(f"anchors_class_{i}",
                                 torch.from_numpy(np.ascontiguousarray(a)), persistent=False)
        self.num_anchor_classes = len(per_class)

    def _anchors(self):
        return self.anchors_flat.float()

    def head_forward(self, spatial):
        """The BEV map (B, H, W, C) -> the forward dict, ``batch_cls_preds``
        (B, A, C) logits and ``batch_box_preds`` (B, A, 7) among it; with
        ``AnchorHeadMulti`` also each head's maps (``head_outs``)."""
        spatial_2d = self.backbone_2d(spatial)
        head_cfg = self.cfg.DENSE_HEAD
        head_outs = None
        if self.head_groups is not None:
            head_outs = self.dense_head(spatial_2d)
            cls_preds, box_preds, dir_preds = AHM.concat_head_preds(
                head_outs, self.head_groups, self.num_class, self.box_coder.code_size,
                head_cfg.get("NUM_DIR_BINS", 2), head_cfg.get("SEPARATE_MULTIHEAD", False))
        else:
            cls_preds, box_preds, dir_preds = self.dense_head(spatial_2d)
        batch_cls, batch_boxes = AH.generate_predicted_boxes(
            cls_preds, box_preds, dir_preds, self._anchors(), self.box_coder, self.num_class,
            dir_offset=head_cfg.get("DIR_OFFSET", 0.78539),
            dir_limit_offset=head_cfg.get("DIR_LIMIT_OFFSET", 0.0),
            num_dir_bins=head_cfg.get("NUM_DIR_BINS", 2))
        out = {"cls_preds": cls_preds, "box_preds": box_preds, "dir_cls_preds": dir_preds,
               "batch_cls_preds": batch_cls, "batch_box_preds": batch_boxes,
               "spatial_features": spatial, "spatial_features_2d": spatial_2d}
        if head_outs is not None:
            out["head_outs"] = head_outs
        return out

    def forward_batch(self, batch):
        return self(batch["voxels"], batch["voxel_coords"], batch["voxel_num_points"])

    def loss(self, forward_out, gt_boxes):
        """Target assignment on ``gt_boxes`` (B, M, 8) and the head's loss:
        ``(loss, tb_dict)``."""
        head_cfg = self.cfg.DENSE_HEAD
        gen = head_cfg.ANCHOR_GENERATOR_CONFIG
        per_class = [getattr(self, f"anchors_class_{i}").float()
                     for i in range(self.num_anchor_classes)]
        class_ids = [self.class_names.index(c["class_name"]) + 1 for c in gen]
        thresholds = [(c["matched_threshold"], c["unmatched_threshold"]) for c in gen]
        weights = dict(head_cfg.LOSS_CONFIG.LOSS_WEIGHTS)
        dir_kw = dict(dir_offset=head_cfg.get("DIR_OFFSET", 0.78539),
                      num_dir_bins=head_cfg.get("NUM_DIR_BINS", 2))
        if self.head_groups is not None:
            targets = AHM.assign_targets_multi(per_class, self.head_groups, gt_boxes,
                                               class_ids, thresholds, self.box_coder)
            return AHM.anchor_head_multi_loss(
                forward_out["head_outs"], self.head_groups, self.head_anchor_counts, targets,
                self._anchors(), self.num_class, weights, self.box_coder.code_size,
                separate=head_cfg.get("SEPARATE_MULTIHEAD", False), **dir_kw)
        ta_cfg = head_cfg.TARGET_ASSIGNER_CONFIG
        if ta_cfg.get("NAME", "AxisAlignedTargetAssigner") == "ATSS":
            # every class's anchors at once, in the head's order (JAX
            # second.py:211-218, pointpillar.py:140-147)
            targets = atss_assign_targets(self._anchors(), gt_boxes, int(ta_cfg.TOPK),
                                          self.box_coder, ta_cfg.get("MATCH_HEIGHT", False))
        else:
            targets = AH.assign_targets(per_class, gt_boxes, class_ids, thresholds,
                                        self.box_coder)
        return AH.anchor_head_loss(
            forward_out["cls_preds"], forward_out["box_preds"], forward_out["dir_cls_preds"],
            targets, self._anchors(), self.num_class, weights, **dir_kw)

    def loss_batch(self, forward_out, batch):
        return self.loss(forward_out, batch["gt_boxes"])
