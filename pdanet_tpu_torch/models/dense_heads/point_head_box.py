"""PointHeadBox: counterpart of ``pdanet_tpu/models/dense_heads/
point_head_box.py`` (``pcdet/models/dense_heads/point_head_box.py``).  A
per-point classification stack and a box-regression stack over the point
features, the boxes decoded by the point box coder at every forward
(``generate_predicted_boxes``), and the focal classification plus the
weighted smooth-L1 box loss against ``assign_stack_targets``' labels.
Part-A2-free decodes its proposals with ``generate_predicted_boxes``.

In a process group the positive count that normalizes the losses is the
global batch's, as under the JAX package's GSPMD sums (``parallel``).
"""

import torch

from ... import parallel
from ...utils import loss_utils
from ...utils.easydict import EasyDict
from .point_head_simple import PointStacks, focal_cls_loss, point_targets


class PointHeadBoxNet(PointStacks):
    """The ``CLS_FC`` and ``REG_FC`` stacks (JAX :25-51): 1 class output with
    ``CLASS_AGNOSTIC``, else ``num_class``; ``code_size`` box codes."""

    def __init__(self, model_cfg, in_features, num_class, code_size):
        super().__init__()
        cfg = EasyDict(model_cfg)
        self.add_stack("cls", in_features, cfg.CLS_FC,
                       1 if cfg.get("CLASS_AGNOSTIC", False) else num_class)
        self.add_stack("box", in_features, cfg.REG_FC, code_size)

    def forward(self, point_features):
        return self.stack("cls", point_features), self.stack("box", point_features)


def generate_predicted_boxes(points, point_cls_preds, point_box_preds, box_coder):
    """The per-point decode (JAX :54-66): points (B, N, 3), the class
    logits (B, N, C) and box codes (B, N, code) -> (the logits, the (B, N,
    7) boxes of each point's best class)."""
    pred_classes = point_cls_preds.argmax(dim=-1) + 1
    return point_cls_preds, box_coder.decode(point_box_preds, points, pred_classes)


def box_reg_loss(point_box_preds, box_labels, positives, pos_norm, weights):
    """The weighted smooth-L1 of the positive points' codes over the
    positive count (at least 1)."""
    reg_weights = positives.to(torch.float32) / pos_norm.clamp(min=1.0)
    per = loss_utils.weighted_smooth_l1_loss(point_box_preds, box_labels,
                                             code_weights=weights.get("code_weights", None))
    return (per.sum(dim=-1) * reg_weights).sum() * weights.get("point_box_weight", 1.0)


def point_head_box_loss(point_cls_preds, point_box_preds, point_coords, gt_boxes, box_coder,
                        model_cfg, num_class):
    """Focal classification plus weighted smooth-L1 box loss (JAX :69-117):
    ``(loss, tb)``."""
    cfg = EasyDict(model_cfg)
    t = point_targets(point_coords, gt_boxes, cfg, box_coder)
    labels = t["point_cls_labels"]
    if cfg.get("CLASS_AGNOSTIC", False):
        labels = torch.where(labels > 0, 1, labels)
    positives = labels > 0
    pos_norm = parallel.all_reduce_detached(positives.sum().to(torch.float32))
    weights = EasyDict(cfg.LOSS_CONFIG).LOSS_WEIGHTS
    cls_loss = focal_cls_loss(point_cls_preds, labels, labels >= 0, pos_norm) * weights.get(
        "point_cls_weight", 1.0)
    box_loss = box_reg_loss(point_box_preds, t["point_box_labels"], positives, pos_norm,
                            weights)
    return cls_loss + box_loss, {"point_loss_cls": cls_loss, "point_loss_box": box_loss,
                                 "point_pos_num": positives.sum().to(torch.float32)}
