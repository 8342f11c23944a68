"""PV-RCNN and PV-RCNN++: counterpart of
``pdanet_tpu/models/detectors/pv_rcnn.py`` (``pcdet/models/detectors/
pv_rcnn.py`` and ``pv_rcnn_plusplus.py``).  SECOND's first stage, the
proposal layer, the voxel set abstraction's keypoints and features
(``backbones_3d/pfe``), the keypoint segmentation head
(``PointHeadSimple``) and the RoI grid pool and refinement
(``PVRCNNHead``); the loss is the RPN loss, the point loss and the RCNN
loss.  PV-RCNN++ is the same pipeline: its yaml swaps in SPC keypoint
sampling and VectorPool aggregation, which the shared modules dispatch.

The device batch carries the raw points (at the ``sample_points`` budget)
beside the voxel triplet (``DEVICE_BATCH_KEYS``).  The gradient stops where
the JAX package stops it (:78-81, 136-139, 155-158): at the proposal
layer's inputs and at the RoIs that the VSA and the RoI head read; the VSA
reads the backbone levels and the BEV map undetached, so that the point
and RCNN losses train the backbones too.  Training draws (the RoI
sampler's uniforms, the dropout keep masks) are a value, as for
Voxel-RCNN (:meth:`train_draws`).
"""

import torch

from ...utils.box_coder_utils import build_box_coder
from ...utils.easydict import EasyDict
from ..backbones_3d.pfe.voxel_set_abstraction import (VoxelSetAbstraction,
                                                      multi_scale_occupancy)
from ..dense_heads.point_head_simple import PointHeadSimpleNet, point_head_simple_loss
from ..roi_heads import roi_head_template as RHT
from ..roi_heads.pvrcnn_head import PVRCNNHeadNet
from .second import SECOND

BEV_STRIDE = 8  # the BEV map the VSA samples, before the 2-D backbone


class PVRCNN(SECOND):
    """MODEL.NAME: PVRCNN, its grid from the dataset (``build_network(...,
    dataset=...)``), over the sparse or the dense 3-D backbones of SECOND."""

    DEVICE_BATCH_KEYS = ("voxels", "voxel_coords", "voxel_num_points", "points", "gt_boxes")

    def __init__(self, model_cfg, num_class, input_channels=4, grid_size=None,
                 voxel_size=None, point_cloud_range=None, class_names=None):
        super().__init__(model_cfg, num_class, input_channels, grid_size, voxel_size,
                         point_cloud_range, class_names)
        cfg = self.cfg
        self.pfe_cfg = EasyDict(cfg.PFE)
        widths = self.backbone_3d.widths
        self.pfe = VoxelSetAbstraction(
            self.pfe_cfg, voxel_size, point_cloud_range, self.backbone_3d.num_bev_features,
            {f"x_conv{i}": widths[i] for i in range(1, 5)}, num_rawpoint_features=input_channels)
        self.point_cfg = EasyDict(cfg.POINT_HEAD)
        before = self.point_cfg.get("USE_POINT_FEATURES_BEFORE_FUSION", False)
        self.point_head = PointHeadSimpleNet(
            self.point_cfg, self.pfe.fusion.in_features if before
            else self.pfe.fusion.out_features, num_class)
        self.roi_cfg = cfg.ROI_HEAD
        target_cfg = self.roi_cfg.TARGET_CONFIG
        self.roi_box_coder = build_box_coder(target_cfg.BOX_CODER,
                                             target_cfg.get("BOX_CODER_CONFIG", {}))
        n_cls = 1 if self.roi_cfg.get("CLASS_AGNOSTIC", True) else num_class
        self.roi_head = PVRCNNHeadNet(self.roi_cfg, self.pfe.fusion.out_features,
                                      self.roi_box_coder.code_size, n_cls)
        voxel_srcs = [s for s in self.pfe.sources if s not in ("bev", "raw_points")]
        self.strides = sorted({int(self.pfe_cfg.SA_LAYER[s].DOWNSAMPLE_FACTOR)
                               for s in voxel_srcs})

    def forward(self, voxels, voxel_coords, voxel_num_points, points, gt_boxes=None,
                draws=None):
        """The voxel triplet and the raw points (B, N, 3 + C) -> the forward
        dict; in training mode with ``gt_boxes`` (B, M, 8) and ``draws``
        (:meth:`train_draws`)."""
        out = super().forward(voxels, voxel_coords, voxel_num_points)
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
        rois = rois.detach()
        # the occupancy pyramid feeds the dense levels alone: a sparse level
        # carries its own sites
        ms = out["multi_scale_3d_features"]
        dense = any(not isinstance(ms[s], (tuple, list)) for s in self.pfe.sources
                    if s not in ("bev", "raw_points"))
        occ = multi_scale_occupancy(voxel_coords, self.grid_size, self.strides) if dense else {}
        vsa = self.pfe(points, ms, occ, out["spatial_features"], BEV_STRIDE, rois=rois)
        out.update(vsa)
        head_in = (vsa["point_features_before_fusion"]
                   if self.point_cfg.get("USE_POINT_FEATURES_BEFORE_FUSION", False)
                   else vsa["point_features"])
        point_cls_preds = self.point_head(head_in)
        point_cls_scores = torch.sigmoid(point_cls_preds).max(dim=-1).values  # (B, K)
        out["point_cls_preds"] = point_cls_preds
        out["point_cls_scores"] = point_cls_scores
        weighted = vsa["point_features"] * point_cls_scores[..., None]
        rcnn_cls, rcnn_reg = self.roi_head(vsa["point_coords"], weighted, rois, keep)
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
        return RHT.frame_draws(self.roi_cfg, self.roi_head, self.anchors_flat.shape[0],
                               generators, device)

    def forward_batch(self, batch, draws=None):
        return self(batch["voxels"], batch["voxel_coords"], batch["voxel_num_points"],
                    batch["points"], gt_boxes=batch.get("gt_boxes"), draws=draws)

    def loss(self, forward_out, gt_boxes):
        """The RPN loss, the point loss and the RCNN cls and reg (with
        corner) losses: ``(loss, tb_dict)``."""
        rpn_loss, tb = super().loss(forward_out, gt_boxes)
        tb = dict(tb)
        point_loss, tb_p = point_head_simple_loss(forward_out["point_cls_preds"],
                                                  forward_out["point_coords"], gt_boxes,
                                                  self.point_cfg)
        tb.update(tb_p)
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
        return rpn_loss + point_loss + rcnn_loss, tb


class PVRCNNPlusPlus(PVRCNN):
    """MODEL.NAME: PVRCNNPlusPlus (JAX :191-196): PV-RCNN's pipeline; the
    yaml gives SPC sampling and VectorPool aggregation."""
