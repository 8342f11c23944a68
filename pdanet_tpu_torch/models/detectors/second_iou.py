"""SECOND-IoU: counterpart of ``pdanet_tpu/models/detectors/second_iou.py``
(``pcdet/models/detectors/second_net_iou.py``): SECOND's first stage, the
proposal layer, and an RoI stage that re-scores each proposal with an
IoU-quality logit from its rotated BEV patch (``roi_heads/second_head.py``);
the boxes are not refined.

The gradient stops where the JAX package stops it (:44-48, 62-69): at the
proposal layer's inputs, and at the BEV map and the RoIs the pool reads,
so that the IoU loss trains the RoI head alone.  Training draws (the RoI
sampler's uniforms, the dropout keep masks) are a value the caller passes
(``draws``, from :meth:`SECONDNetIoU.train_draws`).  At eval
``batch_box_preds`` are the RoIs and ``batch_cls_preds`` the IoU logits
(:79-82), beside the proposals' ``rois``, ``roi_scores``, ``roi_labels``
and ``roi_valid``; :func:`post_processing` scores them by ``SCORE_TYPE``.
"""

import torch

from ..model_utils.model_nms_utils import batched_nms_candidates
from ..roi_heads import roi_head_template as RHT
from ..roi_heads.second_head import SECONDHeadNet, second_head_iou_loss
from .second import SECOND


class SECONDNetIoU(SECOND):
    """MODEL.NAME: SECONDNetIoU, its grid from the dataset (``build_network(
    ..., dataset=...)``), over any 3-D backbone of SECOND (the shipped yaml
    names the dense ``VoxelBackBone8x``)."""

    def __init__(self, model_cfg, num_class, input_channels=4, grid_size=None,
                 voxel_size=None, point_cloud_range=None, class_names=None):
        super().__init__(model_cfg, num_class, input_channels, grid_size, voxel_size,
                         point_cloud_range, class_names)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.roi_cfg = self.cfg.ROI_HEAD
        g = int(self.roi_cfg.ROI_GRID_POOL.GRID_SIZE)
        self.roi_head = SECONDHeadNet(self.roi_cfg,
                                      g * g * self.backbone_2d.num_bev_features)

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
                raise ValueError("SECONDNetIoU trains on gt_boxes and draws (train_draws)")
            targets = RHT.assign_targets(proposals, gt_boxes, self.roi_cfg.TARGET_CONFIG,
                                         draws["sampler"])
            rois = targets["rois"]
            out["roi_targets"] = targets
            keep = draws.get("dropout")
        else:
            rois = proposals["rois"]
            for key in ("rois", "roi_scores", "roi_labels", "roi_valid"):
                out[key] = proposals[key]
        pool_cfg = self.roi_cfg.ROI_GRID_POOL
        pooled = RHT.roi_grid_pool_bev(out["spatial_features_2d"].detach(), rois.detach(),
                                       int(pool_cfg.GRID_SIZE), self.point_cloud_range,
                                       self.voxel_size, int(pool_cfg.DOWNSAMPLE_RATIO))
        out["rcnn_iou"] = self.roi_head(pooled, keep)
        if not self.training:
            out["batch_box_preds"] = rois
            out["batch_cls_preds"] = out["rcnn_iou"]
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
        """SECOND's RPN loss plus the IoU loss (JAX :85-96): ``(loss,
        tb_dict)``."""
        rpn_loss, tb = super().loss(forward_out, gt_boxes)
        rcnn_loss, tb_rcnn = second_head_iou_loss(
            forward_out["rcnn_iou"], forward_out["roi_targets"]["rcnn_cls_labels"],
            self.roi_cfg.LOSS_CONFIG)
        tb = dict(tb)
        tb.update(tb_rcnn)
        tb["rcnn_loss"] = rcnn_loss
        return rpn_loss + rcnn_loss, tb


def post_processing(forward_out, model_cfg):
    """The RoIs' scores and final NMS (second_net_iou.py:74-160, JAX
    :102-133): ``SCORE_TYPE`` iou (the sigmoid of the IoU logit, the
    default), cls (of the proposal's logit) or weighted_iou_cls
    (``SCORE_WEIGHTS``), the proposals' labels, the rotated NMS over the
    valid RoIs at ``SCORE_THRESH``."""
    post_cfg = model_cfg.POST_PROCESSING
    nms_cfg = post_cfg.NMS_CONFIG
    iou_preds = torch.sigmoid(forward_out["rcnn_iou"].max(dim=-1).values)
    cls_preds = torch.sigmoid(forward_out["roi_scores"])
    score_type = nms_cfg.get("SCORE_TYPE", "iou")
    if score_type == "iou":
        scores = iou_preds
    elif score_type == "cls":
        scores = cls_preds
    elif score_type == "weighted_iou_cls":
        w = nms_cfg.SCORE_WEIGHTS
        scores = w["iou"] * iou_preds + w["cls"] * cls_preds
    else:
        raise NotImplementedError(f"SCORE_TYPE {score_type}")
    return batched_nms_candidates(forward_out["batch_box_preds"], scores,
                                  forward_out["roi_labels"], forward_out["roi_valid"], nms_cfg,
                                  score_thresh=post_cfg.get("SCORE_THRESH", None))
