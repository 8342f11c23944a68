"""Part-A2: counterpart of ``pdanet_tpu/models/detectors/part_a2.py``
(``pcdet/models/detectors/PartA2_net.py``).  SECOND's first stage over a
UNetV2 (the sparse one in the shipped ``PartA2.yaml``), the
intra-part head on the decoder's voxel rows
(``dense_heads/point_intra_part_head.py``), the proposal layer, and the
RoI-aware refinement (``roi_heads/partA2_head.py``); the loss is the RPN
loss, the point loss and the RCNN loss.

The second stage is shared with Part-A2-free (``PartA2Refine``): the
gradient stops where the JAX package stops it (:90-94, 112-117), at the
proposal layer's inputs, the RoIs, the part offsets and the segmentation
scores, so that the RCNN loss reaches the backbone through the pooled
segmentation features alone.  Training draws (the RoI sampler's uniforms,
the dropout keep masks) are a value (:meth:`train_draws`), as for
Voxel-RCNN.
"""

import torch

from ...utils.box_coder_utils import build_box_coder
from ...utils.easydict import EasyDict
from ..backbones_3d.pfe.voxel_set_abstraction import voxel_centres
from ..dense_heads.point_intra_part_head import (PointIntraPartOffsetHeadNet,
                                                 point_intra_part_loss)
from ..roi_heads import roi_head_template as RHT
from ..roi_heads.partA2_head import PartA2HeadNet
from .second import SECOND


class PartA2Refine:
    """What Part-A2 and Part-A2-free share after their 3-D backbone: the
    intra-part head, the proposal layer, the RoI sampling in training, the
    RoI head and its decode, and the RCNN losses.  A subclass calls
    ``build_refine`` after building its backbone (whose ``widths[1]`` is
    the decoder's channel count) and has ``first_stage``: the forward dict
    up to the proposal layer's inputs."""

    def build_refine(self, cfg, num_class, voxel_size, point_box_coder=None):
        self.voxel_size = tuple(float(v) for v in voxel_size)
        seg_channels = self.backbone_3d.widths[1]
        self.point_cfg = EasyDict(cfg.POINT_HEAD)
        self.point_head = PointIntraPartOffsetHeadNet(
            self.point_cfg, seg_channels, num_class,
            0 if point_box_coder is None else point_box_coder.code_size)
        self.roi_cfg = cfg.ROI_HEAD
        target_cfg = self.roi_cfg.TARGET_CONFIG
        self.roi_box_coder = build_box_coder(target_cfg.BOX_CODER,
                                             target_cfg.get("BOX_CODER_CONFIG", {}))
        n_cls = 1 if self.roi_cfg.get("CLASS_AGNOSTIC", True) else num_class
        self.roi_head = PartA2HeadNet(self.roi_cfg, seg_channels, self.roi_box_coder.code_size,
                                      n_cls)

    def point_stage(self, aux, voxel_coords):
        """The intra-part head over the decoder's ``aux``: the voxel centres
        (``point_coords``, float32 as the JAX package's), the head's logits,
        the segmentation scores and the sigmoided part offsets."""
        coords = voxel_centres(voxel_coords.flip(-1), self.voxel_size, 1,
                               self.point_cloud_range)
        preds = self.point_head(aux["point_features"])
        out = {"point_coords": coords, "point_valid": aux["point_valid"],
               "point_cls_preds": preds[0], "point_part_preds": preds[1],
               "point_cls_scores": torch.sigmoid(preds[0]).max(dim=-1).values,
               "seg_features": aux["point_features"]}
        if len(preds) > 2:
            out["point_box_preds"] = preds[2]
        return out

    def forward(self, voxels, voxel_coords, voxel_num_points, gt_boxes=None, draws=None):
        """The voxel triplet -> the forward dict; in training mode with
        ``gt_boxes`` (B, M, 8) and ``draws`` (:meth:`train_draws`)."""
        return self.refine_stage(self.first_stage(voxels, voxel_coords, voxel_num_points),
                                 gt_boxes, draws)

    def refine_stage(self, out, gt_boxes, draws):
        """The proposals of the first stage's ``batch_cls_preds`` /
        ``batch_box_preds``, the RoI sample in training (``gt_boxes`` and
        ``draws`` given), the RoI head; at eval the refined boxes and scores
        as ``batch_box_preds`` / ``batch_cls_preds``, the proposals'
        ``rois``, ``roi_labels`` and ``roi_valid`` beside them."""
        nms_cfg = self.roi_cfg.NMS_CONFIG["TRAIN" if self.training else "TEST"]
        proposals = RHT.proposal_layer(out["batch_cls_preds"].detach(),
                                       out["batch_box_preds"].detach(), nms_cfg)
        keep = None
        if self.training:
            if gt_boxes is None or draws is None:
                raise ValueError(f"{type(self).__name__} trains on gt_boxes and draws "
                                 f"(train_draws)")
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
        rcnn_cls, rcnn_reg = self.roi_head(
            out["point_coords"], out["seg_features"],
            torch.sigmoid(out["point_part_preds"]).detach(), out["point_cls_scores"].detach(),
            out["point_valid"], rois.detach(), keep)
        out["rcnn_cls"] = rcnn_cls
        out["rcnn_reg"] = rcnn_reg
        if not self.training:
            out["batch_box_preds"] = RHT.decode_roi_boxes(rois, rcnn_reg, self.roi_box_coder)
            out["batch_cls_preds"] = rcnn_cls
        return out

    def train_draws(self, generators, device):
        """The draws of one training forward, one CPU ``torch.Generator`` a
        frame (``RHT.frame_draws``): the sampler's uniforms, then the
        dropout keep masks of ``roi_head.dropout_shapes``."""
        anchors = getattr(self, "anchors_flat", None)
        return RHT.frame_draws(self.roi_cfg, self.roi_head,
                               None if anchors is None else anchors.shape[0], generators,
                               device)

    def forward_batch(self, batch, draws=None):
        return self(batch["voxels"], batch["voxel_coords"], batch["voxel_num_points"],
                    gt_boxes=batch.get("gt_boxes"), draws=draws)

    def point_loss(self, forward_out, gt_boxes, box_coder=None):
        return point_intra_part_loss(
            forward_out["point_cls_preds"], forward_out["point_part_preds"],
            forward_out["point_coords"], forward_out["point_valid"], gt_boxes, self.point_cfg,
            point_box_preds=forward_out.get("point_box_preds"), box_coder=box_coder)

    def rcnn_loss(self, forward_out):
        """The RCNN cls and reg (with corner) losses: ``(loss, tb)``."""
        targets = dict(forward_out["roi_targets"])
        targets["rcnn_cls"] = forward_out["rcnn_cls"]
        targets["rcnn_reg"] = forward_out["rcnn_reg"]
        loss_cfg = self.roi_cfg.LOSS_CONFIG
        cls_loss, tb = RHT.roi_box_cls_loss(forward_out["rcnn_cls"],
                                            targets["rcnn_cls_labels"], loss_cfg)
        reg_loss, tb_r = RHT.roi_box_reg_loss(targets, self.roi_box_coder, loss_cfg)
        tb.update(tb_r)
        tb["rcnn_loss"] = cls_loss + reg_loss
        return tb["rcnn_loss"], tb


class PartA2Net(PartA2Refine, SECOND):
    """MODEL.NAME: PartA2Net, its grid from the dataset (``build_network(...,
    dataset=...)``), over the sparse or the dense UNetV2."""

    def __init__(self, model_cfg, num_class, input_channels=4, grid_size=None,
                 voxel_size=None, point_cloud_range=None, class_names=None):
        super().__init__(model_cfg, num_class, input_channels, grid_size, voxel_size,
                         point_cloud_range, class_names)
        self.build_refine(self.cfg, num_class, voxel_size)

    def first_stage(self, voxels, voxel_coords, voxel_num_points):
        """SECOND's forward dict and the intra-part head's outputs."""
        out = SECOND.forward(self, voxels, voxel_coords, voxel_num_points)
        out.update(self.point_stage(out["multi_scale_3d_features"], voxel_coords))
        return out

    def loss(self, forward_out, gt_boxes):
        """The RPN loss, the intra-part loss and the RCNN loss: ``(loss,
        tb_dict)``."""
        rpn_loss, tb = SECOND.loss(self, forward_out, gt_boxes)
        tb = dict(tb)
        point_loss, tb_p = self.point_loss(forward_out, gt_boxes)
        rcnn_loss, tb_r = self.rcnn_loss(forward_out)
        tb.update(tb_p)
        tb.update(tb_r)
        return rpn_loss + point_loss + rcnn_loss, tb
