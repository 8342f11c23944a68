"""PointHeadSimple, PV-RCNN's keypoint segmentation head: counterpart of
``pdanet_tpu/models/dense_heads/point_head_simple.py``
(``pcdet/models/dense_heads/point_head_simple.py``).  The ``CLS_FC``
stack (``cls_fc<k>`` / ``cls_bn<k>``) and a biased ``cls_out`` over the
keypoint features; a focal loss against the keypoints-in-gt-box labels with
the ``GT_EXTRA_WIDTH`` ignore ring, through the dense
``assign_stack_targets`` of the IA-SSD head.  ``PointStacks``,
``point_targets`` and ``focal_cls_loss`` are shared with the point-box and
intra-part heads.

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


class PointStacks(nn.Module):
    """Named stacks over the point features (``make_fc_layers``): Dense (no
    bias) + BatchNorm (eps 1e-5, momentum 0.9) + ReLU layers
    ``<prefix>_fc<k>`` / ``<prefix>_bn<k>``, then a biased ``<prefix>_out``."""

    def add_stack(self, prefix, c_in, widths, n_out):
        c = int(c_in)
        for k, f in enumerate(widths):
            self.add_module(f"{prefix}_fc{k}", Dense(c, int(f), bias=False))
            self.add_module(f"{prefix}_bn{k}", BatchNorm(int(f)))
            c = int(f)
        self.add_module(f"{prefix}_out", Dense(c, int(n_out)))
        self.depth = {**getattr(self, "depth", {}), prefix: len(widths)}

    def stack(self, prefix, x):
        for k in range(self.depth[prefix]):
            x = torch.relu(getattr(self, f"{prefix}_bn{k}")(getattr(self, f"{prefix}_fc{k}")(x)))
        return getattr(self, f"{prefix}_out")(x)


class PointHeadSimpleNet(PointStacks):
    """The ``CLS_FC`` stack and its ``cls_out`` layer (JAX :25-44): 1 output
    with ``CLASS_AGNOSTIC``, else ``num_class``."""

    def __init__(self, model_cfg, in_features, num_class=1):
        super().__init__()
        cfg = EasyDict(model_cfg)
        self.add_stack("cls", in_features, cfg.CLS_FC,
                       1 if cfg.get("CLASS_AGNOSTIC", False) else num_class)

    def forward(self, point_features):
        return self.stack("cls", point_features)


def point_targets(point_coords, gt_boxes, model_cfg, box_coder=None):
    """``assign_stack_targets`` of the points against ``gt_boxes`` (B, M, 8)
    with the ``GT_EXTRA_WIDTH`` ignore ring, the box labels with a coder."""
    cfg = EasyDict(model_cfg)
    B, _, C = gt_boxes.shape
    ext = enlarge_box3d(gt_boxes.reshape(-1, C),
                        cfg.TARGET_CONFIG.GT_EXTRA_WIDTH).reshape(B, -1, C)
    return assign_stack_targets(point_coords, gt_boxes, ext, set_ignore_flag=True,
                                ret_box_labels=box_coder is not None, box_coder=box_coder)


def focal_cls_loss(point_cls_preds, labels, cls_mask, pos_norm):
    """The sigmoid focal loss of the labelled points (``cls_mask``) over the
    positive count (at least 1), one-hot without the background column.  The
    weights are float32 whatever the model's dtype, as the JAX package
    computes them."""
    cls_weights = cls_mask.to(torch.float32) / pos_norm.clamp(min=1.0)
    one_hot = F.one_hot(labels.clamp(min=0), point_cls_preds.shape[-1] + 1).to(
        point_cls_preds.dtype)[..., 1:]
    return loss_utils.sigmoid_focal_loss(point_cls_preds, one_hot, cls_weights).sum()


def point_head_simple_loss(point_cls_preds, point_coords, gt_boxes, model_cfg):
    """The focal segmentation loss (JAX :47-84): point_cls_preds (B, K,
    C'), point_coords (B, K, 3), gt_boxes (B, M, 8) -> ``(loss, tb)``.
    Weight 1 on foreground and background keypoints, 0 on the ignore ring,
    over the positive count (at least 1)."""
    cfg = EasyDict(model_cfg)
    labels = point_targets(point_coords, gt_boxes, cfg)["point_cls_labels"]
    if cfg.get("CLASS_AGNOSTIC", False):
        labels = torch.where(labels > 0, 1, labels)
    positives = labels > 0
    pos_norm = parallel.all_reduce_detached(positives.sum().to(torch.float32))
    loss = focal_cls_loss(point_cls_preds, labels, labels >= 0, pos_norm)
    loss = loss * EasyDict(cfg.LOSS_CONFIG).LOSS_WEIGHTS.get("point_cls_weight", 1.0)
    return loss, {"point_loss_cls": loss, "point_pos_num": positives.sum().to(torch.float32)}
