"""Voxel-RCNN: counterpart of ``pdanet_tpu/models/detectors/voxel_rcnn.py``
(``pcdet/models/detectors/voxel_rcnn.py``): SECOND's first stage, the
proposal layer, and the RoI head's multi-scale voxel-query pool and box
refinement (``roi_heads/voxelrcnn_head.py``), with the RPN loss plus the
RCNN classification, regression and corner losses.

The gradient stops where the JAX package stops it (:44-45, 62-67): at the
proposal layer's inputs, at the RoIs and at every sparse level the RoI
head pools from, so that the RCNN loss trains the RoI head alone.

Training draws (the RoI sampler's uniforms and the dropout keep masks)
are a value the caller passes (``draws``, from :meth:`train_draws`);
``train.make_train_step`` makes them from one generator a frame.  At eval
``batch_box_preds`` / ``batch_cls_preds`` are the refined boxes and
scores, with the proposals' ``rois``, ``roi_labels`` and ``roi_valid``
beside them; :func:`post_processing` is the refined NMS of every
two-stage detector of the JAX registry.
"""

import torch

from ...utils.box_coder_utils import build_box_coder
from ..model_utils.model_nms_utils import batched_nms_candidates
from ..roi_heads import roi_head_template as RHT
from ..backbones_3d.voxel_backbone import _DenseBackbone8x
from ..roi_heads.voxelrcnn_head import VoxelRCNNHeadNet
from .second import SECOND

STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}


class VoxelRCNN(SECOND):
    """MODEL.NAME: VoxelRCNN, its grid from the dataset (``build_network(...,
    dataset=...)``), over SECOND's sparse 3-D backbones (the voxel-query
    pool) or its dense ones (the fixed-window ``NeighborGridPool``)."""

    def __init__(self, model_cfg, num_class, input_channels=4, grid_size=None,
                 voxel_size=None, point_cloud_range=None, class_names=None):
        super().__init__(model_cfg, num_class, input_channels, grid_size, voxel_size,
                         point_cloud_range, class_names)
        self.roi_cfg = self.cfg.ROI_HEAD
        target_cfg = self.roi_cfg.TARGET_CONFIG
        self.roi_box_coder = build_box_coder(target_cfg.BOX_CODER,
                                             target_cfg.get("BOX_CODER_CONFIG", {}))
        n_cls = 1 if self.roi_cfg.get("CLASS_AGNOSTIC", True) else num_class
        widths = self.backbone_3d.widths
        channels = {f"x_conv{i}": widths[i] for i in range(1, 5)}
        self.roi_head = VoxelRCNNHeadNet(self.roi_cfg, self.roi_box_coder.code_size, n_cls,
                                         channels, STRIDES, self.grid_size, voxel_size,
                                         point_cloud_range,
                                         dense=isinstance(self.backbone_3d, _DenseBackbone8x))

    def forward(self, voxels, voxel_coords, voxel_num_points, gt_boxes=None, draws=None):
        """The voxel triplet -> the forward dict; in training mode with
        ``gt_boxes`` (B, M, 8) and ``draws`` (:meth:`train_draws`)."""
        out = super().forward(voxels, voxel_coords, voxel_num_points)
        nms_cfg = self.roi_cfg.NMS_CONFIG["TRAIN" if self.training else "TEST"]
        proposals = RHT.proposal_layer(out["batch_cls_preds"].detach(),
                                       out["batch_box_preds"].detach(), nms_cfg)
        keep = None
        if self.training:
            if gt_boxes is None or draws is None:
                raise ValueError("VoxelRCNN trains on gt_boxes and draws (train_draws)")
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
        ms = {k: v.detach() if torch.is_tensor(v) else tuple(t.detach() for t in v)
              for k, v in out["multi_scale_3d_features"].items()}
        rcnn_cls, rcnn_reg = self.roi_head(ms, rois.detach(), keep)
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
                    gt_boxes=batch.get("gt_boxes"), draws=draws)

    def loss(self, forward_out, gt_boxes):
        """SECOND's RPN loss plus the RCNN cls and reg (with corner) losses:
        ``(loss, tb_dict)``."""
        rpn_loss, tb = super().loss(forward_out, gt_boxes)
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
        return rpn_loss + rcnn_loss, tb


def post_processing(forward_out, model_cfg):
    """The refined boxes' post-processing (JAX :111-125): the sigmoid of the
    best refined score, the labels of the proposal stage
    (detector3d_template.py:227-233), the final rotated NMS over the valid
    RoIs at ``SCORE_THRESH``."""
    post_cfg = model_cfg.POST_PROCESSING
    scores = torch.sigmoid(forward_out["batch_cls_preds"].max(dim=-1).values)
    return batched_nms_candidates(forward_out["batch_box_preds"], scores,
                                  forward_out["roi_labels"], forward_out["roi_valid"],
                                  post_cfg.NMS_CONFIG,
                                  score_thresh=post_cfg.get("SCORE_THRESH", None))
