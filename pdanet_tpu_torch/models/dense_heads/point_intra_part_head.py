"""PointIntraPartOffsetHead, Part-A2's per-voxel head: counterpart of
``pdanet_tpu/models/dense_heads/point_intra_part_head.py``
(``pcdet/models/dense_heads/point_intra_part_head.py``).  Over the UNet
decoder's (B, V, C) voxel rows: foreground segmentation (``CLS_FC``), the
intra-object part locations (``PART_FC``: each foreground voxel's offset
in its gt box's frame, over the box's dims, plus 0.5, under a binary cross
entropy) and, for Part-A2-free, a per-voxel box branch (``REG_FC``) under
the point box coder.  Padding rows count as background of weight 0.

In a process group the positive count that normalizes the losses is the
global batch's, as under the JAX package's GSPMD sums (``parallel``).
"""

import torch

from ... import parallel
from ...ops.geometry import rotate_points_along_z
from ...utils.easydict import EasyDict
from .point_head_box import box_reg_loss
from .point_head_simple import PointStacks, focal_cls_loss, point_targets


class PointIntraPartOffsetHeadNet(PointStacks):
    """The ``cls``, ``part`` and, with ``code_size`` > 0, ``box`` stacks
    (JAX :23-60); empty ``*_FC`` lists are single biased layers (the
    shipped Part-A2's)."""

    def __init__(self, model_cfg, in_features, num_class, code_size=0):
        super().__init__()
        cfg = EasyDict(model_cfg)
        self.add_stack("cls", in_features, cfg.get("CLS_FC", []),
                       1 if cfg.get("CLASS_AGNOSTIC", False) else num_class)
        self.add_stack("part", in_features, cfg.get("PART_FC", []), 3)
        self.code_size = int(code_size)
        if self.code_size > 0:
            self.add_stack("box", in_features, cfg.get("REG_FC", []), self.code_size)

    def forward(self, point_features):
        """(B, V, C) -> the class logits, the part logits (B, V, 3) and, with
        the box branch, the box codes."""
        out = (self.stack("cls", point_features), self.stack("part", point_features))
        if self.code_size > 0:
            return out + (self.stack("box", point_features),)
        return out


def intra_part_labels(point_coords, gt_of_points, pos_mask):
    """The canonical intra-box offsets (JAX :63-73,
    point_head_template.py:117-125): each positive point rotated into its
    gt box's frame, over the box's dims (at least 1e-5), plus 0.5; zero
    elsewhere."""
    B, N = pos_mask.shape
    shifted = point_coords - gt_of_points[..., 0:3]
    local = rotate_points_along_z(shifted.reshape(B * N, 1, 3),
                                  -gt_of_points[..., 6].reshape(B * N)).reshape(B, N, 3)
    labels = local / gt_of_points[..., 3:6].clamp(min=1e-5) + 0.5
    return torch.where(pos_mask[..., None], labels, 0.0)


def point_intra_part_loss(point_cls_preds, point_part_preds, point_coords, point_valid,
                          gt_boxes, model_cfg, point_box_preds=None, box_coder=None):
    """The focal segmentation loss, the part loss (the binary cross entropy
    of the sigmoided part logits, clipped at 1e-7, over 3 x the positive
    count) and, with the box branch, the weighted smooth-L1 box loss (JAX
    :76-151): ``(loss, tb)``."""
    cfg = EasyDict(model_cfg)
    t = point_targets(point_coords, gt_boxes, cfg,
                      box_coder if point_box_preds is not None else None)
    labels = torch.where(point_valid, t["point_cls_labels"], 0)
    if cfg.get("CLASS_AGNOSTIC", False):
        labels = torch.where(labels > 0, 1, labels)
    positives = (labels > 0) & point_valid
    pos_count = positives.sum().to(torch.float32)
    pos_norm = parallel.all_reduce_detached(pos_count)
    weights = EasyDict(cfg.LOSS_CONFIG).LOSS_WEIGHTS
    cls_loss = focal_cls_loss(point_cls_preds, labels, (labels >= 0) & point_valid,
                              pos_norm) * weights.get("point_cls_weight", 1.0)
    part_labels = intra_part_labels(point_coords, t["gt_box_of_points"], positives)
    part_pred = torch.sigmoid(point_part_preds)
    eps = 1e-7
    bce = -(part_labels * torch.log(part_pred.clamp(eps, 1.0))
            + (1 - part_labels) * torch.log((1 - part_pred).clamp(eps, 1.0))).sum(dim=-1)
    part_loss = (bce * positives.to(torch.float32)).sum() / (3.0 * pos_norm.clamp(min=1.0))
    part_loss = part_loss * weights.get("point_part_weight", 1.0)
    tb = {"point_loss_cls": cls_loss, "point_loss_part": part_loss, "point_pos_num": pos_count}
    loss = cls_loss + part_loss
    if point_box_preds is not None:
        box_loss = box_reg_loss(point_box_preds, t["point_box_labels"], positives, pos_norm,
                                weights)
        tb["point_loss_box"] = box_loss
        loss = loss + box_loss
    return loss, tb
