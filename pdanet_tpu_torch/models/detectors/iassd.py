"""IASSD detector: backbone + point head, training loss and
post-processing.

Counterpart of ``pdanet_tpu/models/detectors/iassd.py``: the forward
(:25-70), the loss (``loss``, ``loss_batch``, ``compute_loss``, :72-103),
``post_processing`` (:106-172) on its single-NMS path and the recall
record of the eval loop (``generate_recall_record``, :175-206).
"""

import torch
from torch import nn

from ...ops.nms import greedy_nms_mask_batched
from ...ops.rotated_iou import boxes_iou3d, boxes_iou_bev_batched_self
from ...utils.box_coder_utils import build_box_coder
from ...utils.easydict import EasyDict
from ..backbones_3d.iassd_backbone import IASSDBackbone
from ..dense_heads import iassd_head


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
        if head_cfg.get("IOU_FC"):
            raise NotImplementedError(
                "IOU_FC is ROADMAP queue 1 item 4")
        self.point_head = iassd_head.IASSDHeadNet(
            self.backbone_3d.num_point_features, list(head_cfg.CLS_FC),
            list(head_cfg.REG_FC), num_class, self.box_coder.code_size)

    def forward(self, points):
        """points: (B, N, 3 + C). Returns the forward dict."""
        out = self.backbone_3d(points)
        cls_preds, box_preds = self.point_head(out["centers_features"])
        out["center_cls_preds"] = cls_preds
        out["center_box_preds"] = box_preds
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
    (B, POST), pred_labels (B, POST) in 1..C, pred_counts (B,).
    """
    nms_cfg = post_cfg.NMS_CONFIG
    if nms_cfg.get("MULTI_CLASSES_NMS", False):
        raise NotImplementedError(
            "MULTI_CLASSES_NMS is ROADMAP queue 1 item 5")
    scores_all = torch.sigmoid(batch_cls_preds)
    cls_scores = scores_all.max(dim=-1).values
    labels = torch.argmax(scores_all, dim=-1) + 1  # first maximum
    B, N = cls_scores.shape
    pre = min(int(nms_cfg.NMS_PRE_MAXSIZE), N)
    post = min(int(nms_cfg.NMS_POST_MAXSIZE), pre)

    valid = torch.isfinite(cls_scores) & (cls_scores >= post_cfg.SCORE_THRESH)
    masked = torch.where(valid, cls_scores, -torch.inf)
    # stable descending order: equal scores keep the lower index first
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, :pre]
    cand_valid = torch.gather(valid, 1, order)
    cand_boxes = torch.gather(
        batch_box_preds, 1, order[..., None].expand(B, pre, 7)).contiguous()
    iou = boxes_iou_bev_batched_self(cand_boxes)
    keep = greedy_nms_mask_batched(iou, cand_valid.contiguous(),
                                   float(nms_cfg.NMS_THRESH))

    # stable compaction of the kept candidates (already in score order)
    rank = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    src = torch.where(keep & (rank < post), rank, post)
    sel = torch.full((B, post + 1), -1, dtype=torch.int64, device=order.device)
    sel.scatter_(1, src, order)  # slot `post` collects what is dropped
    sel = sel[:, :post]
    counts = torch.clamp(keep.sum(dim=-1), max=post).to(torch.int32)
    hit = sel >= 0
    safe = sel.clamp(min=0)
    out_boxes = torch.gather(batch_box_preds, 1, safe[..., None].expand(B, post, 7))
    return {
        "pred_boxes": torch.where(hit[..., None], out_boxes, 0.0),
        "pred_scores": torch.where(hit, torch.gather(cls_scores, 1, safe), 0.0),
        "pred_labels": torch.where(hit, torch.gather(labels, 1, safe), 0).to(torch.int32),
        "pred_counts": counts,
    }


def generate_recall_record(pred_boxes, pred_valid, gt_boxes, thresh_list):
    """Recall against the gt at 3-D IoU thresholds
    (detector3d_template.py:287-329), per frame.

    pred_boxes (..., P, 7), pred_valid (..., P) bool, gt_boxes (..., M, 8)
    zero-padded -> ``{"gt": count, "rcnn_<t>": recalled count}``, int64
    tensors of the leading shape.  A single-stage detector has no
    first-stage rois, so no ``roi_<t>`` counts."""
    gt_valid = (gt_boxes[..., 0:7] != 0).any(dim=-1)
    iou = boxes_iou3d(pred_boxes, gt_boxes[..., 0:7])  # (..., P, M)
    iou = torch.where(pred_valid.unsqueeze(-1) & gt_valid.unsqueeze(-2), iou, 0.0)
    best_per_gt = iou.max(dim=-2).values
    out = {"gt": gt_valid.sum(dim=-1)}
    for t in thresh_list:
        out[f"rcnn_{t}"] = (best_per_gt > t).sum(dim=-1)
    return out
