"""PointRCNN: counterpart of ``pdanet_tpu/models/detectors/point_rcnn.py``
(``pcdet/models/detectors/point_rcnn.py``).  The PointNet++ MSG backbone
with its FP decoder (``backbones_3d/pointnet2_backbone.py``), the
point-box head (``PointHeadBox``: every point's class logits and its box,
decoded by the ``PointResidualCoder``), whose boxes are the proposals, and
the RoI point-pooling refinement (``roi_heads/pointrcnn_head.py``); the
loss is the point-box loss and the RCNN loss.

The detector is points-only from input to output: its device batch is the
sampled cloud (B, N, 3 + C) and, in training, the gt boxes.  The gradient
stops where the JAX package stops it (:108-112, 128-132): at the proposal
layer's inputs, the point scores and the RoIs that the RoI head reads;
the RoI head reads the backbone's point features undetached, so that the
RCNN loss trains the backbone too.  Training draws (the RoI sampler's
uniforms, the dropout keep masks) are a value (:meth:`train_draws`), as
for the other two-stage detectors.
"""

import torch
from torch import nn

from ...utils.box_coder_utils import build_box_coder
from ...utils.easydict import EasyDict
from ..backbones_3d.pointnet2_backbone import PointNet2MSG
from ..dense_heads import point_head_box as PHB
from ..roi_heads import roi_head_template as RHT
from ..roi_heads.pointrcnn_head import PointRCNNHeadNet


class PointRCNN(nn.Module):
    """MODEL.NAME: PointRCNN over ``PointNet2MSG`` (JAX :21-153)."""

    def __init__(self, model_cfg, num_class, input_channels=4, class_names=None):
        super().__init__()
        self.cfg = EasyDict(model_cfg)
        self.num_class = num_class
        self.class_names = list(class_names or ())
        self.backbone_3d = PointNet2MSG(self.cfg.BACKBONE_3D, input_channels)
        self.point_cfg = EasyDict(self.cfg.POINT_HEAD)
        target_cfg = self.point_cfg.TARGET_CONFIG
        self.point_box_coder = build_box_coder(target_cfg.BOX_CODER,
                                               target_cfg.get("BOX_CODER_CONFIG", {}))
        self.point_head = PHB.PointHeadBoxNet(self.point_cfg,
                                              self.backbone_3d.num_point_features, num_class,
                                              self.point_box_coder.code_size)
        self.roi_cfg = self.cfg.ROI_HEAD
        roi_target = self.roi_cfg.TARGET_CONFIG
        self.roi_box_coder = build_box_coder(roi_target.BOX_CODER,
                                             roi_target.get("BOX_CODER_CONFIG", {}))
        n_cls = 1 if self.roi_cfg.get("CLASS_AGNOSTIC", True) else num_class
        self.roi_head = PointRCNNHeadNet(self.roi_cfg, self.backbone_3d.num_point_features,
                                         self.roi_box_coder.code_size, n_cls)

    def first_stage(self, points):
        """The backbone and the point-box head: the point coordinates and
        features, the head's logits and codes, the sigmoided best-class
        scores, and every point's decoded box (``batch_box_preds``) beside
        its logits (``batch_cls_preds``), the proposal layer's inputs."""
        bb = self.backbone_3d(points)
        point_coords, point_features = bb["point_coords"], bb["point_features"]
        point_cls_preds, point_box_preds = self.point_head(point_features)
        _, batch_box_preds = PHB.generate_predicted_boxes(point_coords, point_cls_preds,
                                                          point_box_preds, self.point_box_coder)
        return {"point_coords": point_coords, "point_features": point_features,
                "point_cls_preds": point_cls_preds, "point_box_preds": point_box_preds,
                "point_cls_scores": torch.sigmoid(point_cls_preds.max(dim=-1).values),
                "batch_cls_preds": point_cls_preds, "batch_box_preds": batch_box_preds}

    def forward(self, points, gt_boxes=None, draws=None):
        """points (B, N, 3 + C) -> the forward dict; in training mode with
        ``gt_boxes`` (B, M, 8) and ``draws`` (:meth:`train_draws`)."""
        out = self.first_stage(points)
        point_coords, point_features = out["point_coords"], out["point_features"]
        point_cls_preds, batch_box_preds = out["batch_cls_preds"], out["batch_box_preds"]
        point_cls_scores = out["point_cls_scores"]
        nms_cfg = self.roi_cfg.NMS_CONFIG["TRAIN" if self.training else "TEST"]
        proposals = RHT.proposal_layer(point_cls_preds.detach(), batch_box_preds.detach(),
                                       nms_cfg)
        keep = None
        if self.training:
            if gt_boxes is None or draws is None:
                raise ValueError("PointRCNN trains on gt_boxes and draws (train_draws)")
            targets = RHT.assign_targets(proposals, gt_boxes, self.roi_cfg.TARGET_CONFIG,
                                         draws["sampler"])
            rois = targets["rois"]
            out["roi_targets"] = targets
            keep = draws.get("dropout")
        else:
            rois = proposals["rois"]
            out["rois"] = rois
            out["roi_labels"] = proposals["roi_labels"]
            out["roi_valid"] = proposals["roi_valid"]
        rcnn_cls, rcnn_reg = self.roi_head(point_coords, point_features,
                                           point_cls_scores.detach(), rois.detach(), keep)
        out["rcnn_cls"] = rcnn_cls
        out["rcnn_reg"] = rcnn_reg
        if not self.training:
            out["batch_box_preds"] = RHT.decode_roi_boxes(rois, rcnn_reg, self.roi_box_coder)
            out["batch_cls_preds"] = rcnn_cls
        return out

    def train_draws(self, generators, device):
        """The draws of one training forward, one CPU ``torch.Generator`` a
        frame (``RHT.frame_draws``): the sampler's uniforms, then the
        dropout keep masks of ``roi_head.dropout_shapes``.  The candidates
        are the cloud's points, which the device batch sets: the count is
        the proposal layer's most, as for Part-A2-free's voxels (the same
        count wherever the cloud holds ``NMS_POST_MAXSIZE`` points)."""
        return RHT.frame_draws(self.roi_cfg, self.roi_head, None, generators, device)

    def forward_batch(self, batch, draws=None):
        return self(batch["points"], gt_boxes=batch.get("gt_boxes"), draws=draws)

    def loss(self, forward_out, gt_boxes):
        """The point-box loss and the RCNN cls and reg (with corner) losses:
        ``(loss, tb_dict)``."""
        point_loss, tb = PHB.point_head_box_loss(
            forward_out["point_cls_preds"], forward_out["point_box_preds"],
            forward_out["point_coords"], gt_boxes, self.point_box_coder, self.point_cfg,
            self.num_class)
        tb = dict(tb)
        targets = dict(forward_out["roi_targets"])
        targets["rcnn_cls"] = forward_out["rcnn_cls"]
        targets["rcnn_reg"] = forward_out["rcnn_reg"]
        loss_cfg = self.roi_cfg.LOSS_CONFIG
        cls_loss, tb_c = RHT.roi_box_cls_loss(forward_out["rcnn_cls"],
                                              targets["rcnn_cls_labels"], loss_cfg)
        reg_loss, tb_r = RHT.roi_box_reg_loss(targets, self.roi_box_coder, loss_cfg)
        tb.update(tb_c)
        tb.update(tb_r)
        rcnn_loss = cls_loss + reg_loss
        tb["rcnn_loss"] = rcnn_loss
        return point_loss + rcnn_loss, tb

    def loss_batch(self, forward_out, batch):
        return self.loss(forward_out, batch["gt_boxes"])
