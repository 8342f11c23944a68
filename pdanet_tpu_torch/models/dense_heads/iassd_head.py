"""IA-SSD / PDA-SSD point head, inference part.

Counterpart of ``pdanet_tpu/models/dense_heads/iassd_head.py``: the
prediction MLPs (``IASSDHeadNet``, :31-50) and the box decode
(``generate_predicted_boxes``, :633-643).  Target assignment and the loss
stack come with training (ROADMAP queue 1 item 6).
"""

import torch
from torch import nn

from ..blocks import Dense, MLPStack


class IASSDHeadNet(nn.Module):
    """Prediction MLPs (IASSD_head.py:28-43)."""

    def __init__(self, channel_in, cls_fc, reg_fc, num_class, code_size):
        super().__init__()
        self.cls_center_layers = MLPStack(channel_in, cls_fc)
        self.cls_center_out = Dense(cls_fc[-1], num_class)
        self.box_center_layers = MLPStack(channel_in, reg_fc)
        self.box_center_out = Dense(reg_fc[-1], code_size)

    def forward(self, center_features):
        cls_preds = self.cls_center_out(self.cls_center_layers(center_features))
        box_preds = self.box_center_out(self.box_center_layers(center_features))
        return cls_preds, box_preds


def generate_predicted_boxes(points, cls_preds, box_preds, box_coder):
    """Decode per-point boxes (point_head_template.py:193-207).

    points (B, N, 3), cls_preds (B, N, C), box_preds (B, N, code) ->
    cls_preds unchanged, boxes (B, N, 7).
    """
    pred_classes = torch.argmax(cls_preds, dim=-1)
    boxes = box_coder.decode(box_preds, points, pred_classes + 1)
    return cls_preds, boxes
