"""PointHeadSimple, PV-RCNN's keypoint segmentation head: counterpart of
``pdanet_tpu/models/dense_heads/point_head_simple.py``
(``pcdet/models/dense_heads/point_head_simple.py``).  The ``CLS_FC``
stack (``cls_fc<k>`` / ``cls_bn<k>``) and a biased ``cls_out`` over the
keypoint features; a focal loss against the keypoints-in-gt-box labels with
the ``GT_EXTRA_WIDTH`` ignore ring, through the dense
``assign_stack_targets`` of the IA-SSD head.

In a process group the positive count that normalizes the loss is the
global batch's, as under the JAX package's GSPMD sums (``parallel``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ... import parallel
from ...ops.geometry import enlarge_box3d
from ...utils import loss_utils
from ...utils.easydict import EasyDict
from ..blocks import BatchNorm, Dense
from .iassd_head import assign_stack_targets


class PointHeadSimpleNet(nn.Module):
    """The ``CLS_FC`` Dense (no bias) + BatchNorm + ReLU stack and the
    ``cls_out`` layer (JAX :25-44): 1 output with ``CLASS_AGNOSTIC``, else
    ``num_class``."""

    def __init__(self, model_cfg, in_features, num_class=1):
        super().__init__()
        cfg = EasyDict(model_cfg)
        self.n = len(cfg.CLS_FC)
        c = int(in_features)
        for k, f in enumerate(cfg.CLS_FC):
            self.add_module(f"cls_fc{k}", Dense(c, int(f), bias=False))
            self.add_module(f"cls_bn{k}", BatchNorm(int(f)))
            c = int(f)
        self.cls_out = Dense(c, 1 if cfg.get("CLASS_AGNOSTIC", False) else num_class)

    def forward(self, point_features):
        x = point_features
        for k in range(self.n):
            x = torch.relu(getattr(self, f"cls_bn{k}")(getattr(self, f"cls_fc{k}")(x)))
        return self.cls_out(x)


def point_head_simple_loss(point_cls_preds, point_coords, gt_boxes, model_cfg):
    """The focal segmentation loss (JAX :47-84): point_cls_preds (B, K,
    C'), point_coords (B, K, 3), gt_boxes (B, M, 8) -> ``(loss, tb)``.
    Weight 1 on foreground and background keypoints, 0 on the ignore ring,
    over the positive count (at least 1)."""
    cfg = EasyDict(model_cfg)
    B, K, n_out = point_cls_preds.shape
    ext = enlarge_box3d(gt_boxes.reshape(-1, gt_boxes.shape[-1]),
                        cfg.TARGET_CONFIG.GT_EXTRA_WIDTH).reshape(B, -1, gt_boxes.shape[-1])
    labels = assign_stack_targets(point_coords, gt_boxes, ext,
                                  set_ignore_flag=True)["point_cls_labels"]
    if cfg.get("CLASS_AGNOSTIC", False):
        labels = torch.where(labels > 0, 1, labels)
    # the weights in float32 whatever the model's dtype, as the JAX package
    # computes them
    positives = labels > 0
    pos_norm = parallel.all_reduce_detached(positives.sum().to(torch.float32))
    cls_weights = (labels >= 0).to(torch.float32) / pos_norm.clamp(min=1.0)
    one_hot = F.one_hot(labels.clamp(min=0), n_out + 1).to(point_cls_preds.dtype)[..., 1:]
    loss = loss_utils.sigmoid_focal_loss(point_cls_preds, one_hot, cls_weights).sum()
    loss = loss * EasyDict(cfg.LOSS_CONFIG).LOSS_WEIGHTS.get("point_cls_weight", 1.0)
    return loss, {"point_loss_cls": loss, "point_pos_num": positives.sum().to(torch.float32)}
