"""IASSD detector: backbone + point head, training loss and
post-processing.

Counterpart of ``pdanet_tpu/models/detectors/iassd.py``: the forward
(:25-70), the loss (``loss``, ``loss_batch``, ``compute_loss``, :72-103),
``post_processing`` (:106-172), single- or multi-class NMS, and the recall
record of the eval loop (``generate_recall_record``, :175-206), which
also counts a two-stage detector's first-stage proposals.
"""

import torch
from torch import nn

from ...ops.rotated_iou import boxes_iou3d
from ...utils.box_coder_utils import build_box_coder
from ...utils.easydict import EasyDict
from ..backbones_3d.iassd_backbone import IASSDBackbone
from ..dense_heads import iassd_head
from ..model_utils.model_nms_utils import batched_multi_classes_nms, batched_nms_candidates


class IASSD(nn.Module):
    """PDA-SSD / IA-SSD detector (MODEL.NAME: IASSD)."""

    def __init__(self, model_cfg, num_class, input_channels=4):
        super().__init__()
        self.cfg = EasyDict(model_cfg)
        self.num_class = num_class
        self.backbone_3d = IASSDBackbone(self.cfg.BACKBONE_3D, num_class,
                                         input_channels)
        head_cfg = self.cfg.POINT_HEAD
        self.box_coder = build_box_coder(
            head_cfg.TARGET_CONFIG.BOX_CODER,
            head_cfg.TARGET_CONFIG.BOX_CODER_CONFIG)
        self.point_head = iassd_head.IASSDHeadNet(
            self.backbone_3d.num_point_features, list(head_cfg.CLS_FC),
            list(head_cfg.REG_FC), num_class, self.box_coder.code_size,
            iou_fc=list(head_cfg.IOU_FC) if head_cfg.get("IOU_FC") else None)

    def forward(self, points):
        """points: (B, N, 3 + C). Returns the forward dict; with ``IOU_FC``
        it holds the IoU head's ``box_iou3d_preds`` (B, N, 1)."""
        out = self.backbone_3d(points)
        cls_preds, box_preds, iou_preds = self.point_head(out["centers_features"])
        out["center_cls_preds"] = cls_preds
        out["center_box_preds"] = box_preds
        if iou_preds is not None:
            out["box_iou3d_preds"] = iou_preds
        _, decoded = iassd_head.generate_predicted_boxes(
            out["centers"], cls_preds, box_preds, self.box_coder)
        out["point_box_preds"] = decoded
        out["batch_cls_preds"] = cls_preds
        out["batch_box_preds"] = decoded
        return out

    def forward_batch(self, batch):
        return self(batch["points"])

    def loss(self, forward_out, gt_boxes):
        """Training loss: target assignment and the loss stack.
        Returns ``(loss, tb_dict)``."""
        return compute_loss(forward_out, gt_boxes, self.cfg, self.box_coder,
                            self.num_class)

    def loss_batch(self, forward_out, batch):
        return self.loss(forward_out, batch["gt_boxes"])


def compute_loss(forward_out, gt_boxes, model_cfg, box_coder, num_class):
    """Target assignment (``gt_boxes`` (B, M, 8), zero-padded) and the
    head's loss stack on the forward dict: ``(loss, tb_dict)``."""
    head_cfg = model_cfg.POINT_HEAD
    targets = iassd_head.assign_targets(forward_out, gt_boxes,
                                        head_cfg.TARGET_CONFIG, box_coder)
    ret = dict(forward_out)
    ret.update(targets)
    return iassd_head.get_loss(ret, head_cfg, box_coder, num_class, gt_boxes.shape[1])


def post_processing(batch_cls_preds, batch_box_preds, post_cfg):
    """Per-frame rotated NMS (detector3d_template.py:179-285).

    batch_cls_preds (B, N, C) raw logits, batch_box_preds (B, N, 7) ->
    fixed-size per-frame outputs: pred_boxes (B, POST, 7), pred_scores
    (B, POST), pred_labels (B, POST) in 1..C, pred_counts (B,); with
    ``MULTI_CLASSES_NMS`` one NMS a class (``batched_multi_classes_nms``),
    C * POST slots.
    """
    nms_cfg = post_cfg.NMS_CONFIG
    scores_all = torch.sigmoid(batch_cls_preds)
    if nms_cfg.get("MULTI_CLASSES_NMS", False):  # JAX :123-131
        return batched_multi_classes_nms(scores_all, batch_box_preds,
                                         torch.ones_like(scores_all[..., 0], dtype=torch.bool),
                                         nms_cfg, score_thresh=float(post_cfg.SCORE_THRESH))
    cls_scores = scores_all.max(dim=-1).values
    labels = torch.argmax(scores_all, dim=-1) + 1  # first maximum
    return batched_nms_candidates(batch_box_preds, cls_scores, labels,
                                  torch.ones_like(cls_scores, dtype=torch.bool), nms_cfg,
                                  score_thresh=post_cfg.SCORE_THRESH)


def generate_recall_record(pred_boxes, pred_valid, gt_boxes, thresh_list, rois=None,
                           roi_valid=None):
    """Recall against the gt at 3-D IoU thresholds
    (detector3d_template.py:287-329), per frame.

    pred_boxes (..., P, 7), pred_valid (..., P) bool, gt_boxes (..., M, 8)
    zero-padded -> ``{"gt": count, "rcnn_<t>": recalled count, "roi_<t>":
    ...}``, int64 tensors of the leading shape.  ``rois`` (..., R, 7) and
    ``roi_valid`` (..., R), a two-stage detector's first-stage proposals,
    give the ``roi_<t>`` counts (JAX :175-206); without them they are 0."""
    gt_valid = (gt_boxes[..., 0:7] != 0).any(dim=-1)

    def best_per_gt(boxes, valid):
        iou = boxes_iou3d(boxes[..., 0:7], gt_boxes[..., 0:7])  # (..., P, M)
        iou = torch.where(valid.unsqueeze(-1) & gt_valid.unsqueeze(-2), iou, 0.0)
        return iou.max(dim=-2).values

    best = best_per_gt(pred_boxes, pred_valid)
    best_roi = None if rois is None else best_per_gt(rois, roi_valid)
    out = {"gt": gt_valid.sum(dim=-1)}
    for t in thresh_list:
        out[f"rcnn_{t}"] = (best > t).sum(dim=-1)
        out[f"roi_{t}"] = (torch.zeros_like(out["gt"]) if best_roi is None
                           else (best_roi > t).sum(dim=-1))
    return out
