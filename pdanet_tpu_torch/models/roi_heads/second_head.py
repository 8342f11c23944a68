"""SECOND-IoU's RoI head: counterpart of ``pdanet_tpu/models/roi_heads/
second_head.py`` (``pcdet/models/roi_heads/second_head.py``).  The pooled
BEV patch of each RoI (``roi_head_template.roi_grid_pool_bev``) goes
through the shared FC stack and the IoU FC stack to one IoU-quality logit;
the box is not refined.

Module and parameter names are the flax ones (``shared_fc0``,
``shared_bn0``, ``iou_fc0``, ``iou_bn0``, ``iou_out``).  Dropout of
``DP_RATIO`` follows every shared layer but the last and the first IoU
layer, in flax's keep-and-scale form, its keep masks a value the caller
gives (:meth:`SECONDHeadNet.dropout_shapes`; ``train.make_train_step``
draws them from each frame's generator).
"""

import torch
from torch import nn

from ... import parallel
from ...utils import loss_utils
from ...utils.easydict import EasyDict
from ..blocks import BatchNorm, Dense
from .roi_head_template import dropout


class SECONDHeadNet(nn.Module):
    """SHARED_FC -> IOU_FC -> one logit (JAX :18-49): Dense (no bias),
    BatchNorm (momentum 0.9, eps 1e-5) and ReLU a layer over every RoI of
    the batch; ``in_features`` is the pooled patch's g * g * C."""

    def __init__(self, model_cfg, in_features):
        super().__init__()
        cfg = EasyDict(model_cfg)
        self.dp = float(cfg.get("DP_RATIO", 0.0))
        self.stacks = {"shared": [int(f) for f in cfg.SHARED_FC],
                       "iou": [int(f) for f in cfg.IOU_FC]}
        c = in_features
        for prefix, widths in self.stacks.items():
            for k, f in enumerate(widths):
                self.add_module(f"{prefix}_fc{k}", Dense(c, f, bias=False))
                self.add_module(f"{prefix}_bn{k}", BatchNorm(f, eps=1e-5, momentum=0.9))
                c = f
        self.iou_out = Dense(c, 1)

    def _dropped(self, prefix, k):
        """True after layer k of the stack: the shared ones but its last
        (with DP_RATIO), the first IoU layer (JAX :36-47)."""
        if self.dp <= 0:
            return False
        return k != len(self.stacks["shared"]) - 1 if prefix == "shared" else k == 0

    def dropout_shapes(self, rois_per_frame):
        """``{name: (R, C)}``: the keep mask a frame of each dropout,
        ``<prefix><k>`` after layer k; none without DP_RATIO."""
        return {f"{prefix}{k}": (rois_per_frame, f) for prefix, widths in self.stacks.items()
                for k, f in enumerate(widths) if self._dropped(prefix, k)}

    def forward(self, pooled, keep=None):
        """pooled (B, R, g, g, C) -> (B, R, 1) IoU logits; ``keep`` the
        dropout keep masks ``{name: (B, R, C) bool}`` in training."""
        if self.training and self.dp > 0 and keep is None:
            raise ValueError("SECONDHeadNet: training with DP_RATIO takes the dropout keep "
                             "masks (train.make_train_step draws them)")
        x = pooled.reshape(pooled.shape[0], pooled.shape[1], -1)
        for prefix, widths in self.stacks.items():
            for k in range(len(widths)):
                x = torch.relu(getattr(self, f"{prefix}_bn{k}")(
                    getattr(self, f"{prefix}_fc{k}")(x)))
                if self.training and self._dropped(prefix, k):
                    x = dropout(x, keep, f"{prefix}{k}", self.dp)
        return self.iou_out(x)


def second_head_iou_loss(rcnn_iou, rcnn_cls_labels, loss_cfg):
    """The IoU-quality loss over every sampled RoI (second_head.py:143-165,
    JAX :52-69): ``IOU_LOSS`` BinaryCrossEntropy (the roi_iou soft labels),
    L2 or smoothL1 (beta 1/9), times ``rcnn_iou_weight``."""
    loss_cfg = EasyDict(loss_cfg)
    flat, labels = rcnn_iou.reshape(-1), rcnn_cls_labels.reshape(-1).to(rcnn_iou.dtype)
    if loss_cfg.IOU_LOSS == "BinaryCrossEntropy":
        per = loss_utils.sigmoid_cross_entropy_with_logits(flat, labels)
    elif loss_cfg.IOU_LOSS == "L2":
        per = (flat - labels) ** 2
    elif loss_cfg.IOU_LOSS == "smoothL1":
        per = loss_utils.smooth_l1(flat - labels, beta=1.0 / 9.0)
    else:
        raise NotImplementedError(f"IOU_LOSS {loss_cfg.IOU_LOSS}")
    # a mean over the global batch's RoIs in a process group
    share = parallel.share(rcnn_iou.shape[0], rcnn_iou)
    loss = per.mean() * share * loss_cfg.LOSS_WEIGHTS.get("rcnn_iou_weight", 1.0)
    return loss, {"rcnn_loss_iou": loss}
