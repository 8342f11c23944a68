"""CenterPoint: counterpart of ``pdanet_tpu/models/detectors/centerpoint.py``
(``pcdet/models/detectors/centerpoint.py``): MeanVFE -> a 3-D voxel
backbone of SECOND's (the height compression folded in) -> BaseBEVBackbone
-> the anchor-free ``CenterHead``.

The decode keeps a fixed top-K of each head with a validity mask, and the
post-processing is one batched rotated NMS over those candidates
(``batched_nms_candidates``) with the head's own
``DENSE_HEAD.POST_PROCESSING.NMS_CONFIG``, as the JAX package's registry
gives it (``detectors/__init__.py:41-43``).  The loss is the head's focal
heatmap loss plus its gathered L1.
"""

import numpy as np
from torch import nn

from ...utils.easydict import EasyDict
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_3d.vfe.mean_vfe import MeanVFE
from ..dense_heads import center_head as CH
from ..model_utils.model_nms_utils import batched_nms_candidates
from .second import BACKBONES_3D


class CenterPoint(nn.Module):
    """MODEL.NAME: CenterPoint, its grid from the dataset
    (``build_network(..., dataset=...)``)."""

    DEVICE_BATCH_KEYS = ("voxels", "voxel_coords", "voxel_num_points", "gt_boxes")

    def __init__(self, model_cfg, num_class, input_channels=4, grid_size=None,
                 voxel_size=None, point_cloud_range=None, class_names=None):
        super().__init__()
        if grid_size is None or voxel_size is None or point_cloud_range is None \
                or class_names is None:
            raise ValueError("CenterPoint takes its grid from the dataset: "
                             "build_network(..., dataset=...)")
        self.cfg = cfg = EasyDict(model_cfg)
        self.num_class = num_class
        self.grid_size = tuple(int(g) for g in grid_size)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        vfe_name = (cfg.get("VFE") or {}).get("NAME", "MeanVFE")
        if vfe_name != "MeanVFE":
            raise ValueError(f"VFE {vfe_name}: the JAX package's CenterPoint builds MeanVFE")
        b3d_cfg = cfg.get("BACKBONE_3D", {})
        b3d_name = b3d_cfg.get("NAME", "VoxelResBackBone8x")
        if b3d_name not in BACKBONES_3D:
            raise ValueError(f"3-D backbone {b3d_name}: the JAX package's CenterPoint has "
                             f"{', '.join(BACKBONES_3D)}")
        self.vfe = MeanVFE(cfg.get("VFE"), input_channels)
        self.backbone_3d = BACKBONES_3D[b3d_name](b3d_cfg, input_channels, self.grid_size)
        self.backbone_2d = BaseBEVBackbone(cfg.BACKBONE_2D, self.backbone_3d.num_bev_features)

        head_cfg = cfg.DENSE_HEAD
        names = list(class_names)
        groups = [[c for c in group if c in names] for group in head_cfg.CLASS_NAMES_EACH_HEAD]
        self.class_ids_each_head = [[names.index(c) + 1 for c in g] for g in groups]  # 1-based
        self.class_id_mapping_each_head = [[names.index(c) for c in g] for g in groups]
        self.head_order = tuple(head_cfg.SEPARATE_HEAD_CFG.HEAD_ORDER)
        self.dense_head = CH.CenterHeadNet(
            head_cfg, self.backbone_2d.num_bev_features, [len(g) for g in groups],
            dict(head_cfg.SEPARATE_HEAD_CFG.HEAD_DICT))
        self.feature_map_stride = int(
            head_cfg.TARGET_ASSIGNER_CONFIG.get("FEATURE_MAP_STRIDE", 4))

    def forward(self, voxels, voxel_coords, voxel_num_points):
        """The voxel triplet (B, V, P, C), (B, V, 3) zyx with -1 pads and
        (B, V) -> ``pred_dicts`` (each head's channels-last maps) and the
        decoded candidates ``batch_box_preds`` (B, n_heads * K, 7),
        ``batch_score_preds``, ``batch_label_preds`` (1-based) and
        ``batch_valid_preds``."""
        spatial, multi_scale = self.backbone_3d(self.vfe(voxels, voxel_num_points),
                                                voxel_coords)
        pred_dicts = self.dense_head(self.backbone_2d(spatial))
        boxes, scores, labels, valid = CH.generate_predicted_boxes(
            pred_dicts, self.class_id_mapping_each_head, self.cfg.DENSE_HEAD.POST_PROCESSING,
            np.asarray(self.point_cloud_range, np.float32),
            np.asarray(self.voxel_size, np.float32), self.feature_map_stride, self.head_order)
        return {"pred_dicts": pred_dicts, "batch_box_preds": boxes,
                "batch_score_preds": scores, "batch_label_preds": labels,
                "batch_valid_preds": valid, "multi_scale_3d_features": multi_scale}

    def forward_batch(self, batch):
        return self(batch["voxels"], batch["voxel_coords"], batch["voxel_num_points"])

    def assign_targets(self, forward_out, gt_boxes):
        """Each head's targets on ``gt_boxes`` (B, M, 8) at the heatmap's
        size."""
        ta = self.cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG
        H, W = forward_out["pred_dicts"][0]["hm"].shape[1:3]
        return [CH.assign_targets_single_head(
            gt_boxes, ids, feature_map_size=(W, H), feature_map_stride=self.feature_map_stride,
            point_cloud_range=self.point_cloud_range, voxel_size=self.voxel_size,
            gaussian_overlap=float(ta.GAUSSIAN_OVERLAP), min_radius=int(ta.MIN_RADIUS))
            for ids in self.class_ids_each_head]

    def loss(self, forward_out, gt_boxes):
        """``(loss, tb)``: the focal heatmap loss and the gathered L1 of
        every head (center_head.py:236-263)."""
        head_cfg = self.cfg.DENSE_HEAD
        return CH.center_head_loss(forward_out["pred_dicts"],
                                   self.assign_targets(forward_out, gt_boxes), self.head_order,
                                   dict(head_cfg.LOSS_CONFIG.LOSS_WEIGHTS))

    def loss_batch(self, forward_out, batch):
        return self.loss(forward_out, batch["gt_boxes"])


def post_processing(forward_out, post_cfg):
    """The final rotated NMS over the decoded candidates (center_head.py:
    294-303), batched at fixed shapes, with ``post_cfg.NMS_CONFIG`` (the
    head's ``DENSE_HEAD.POST_PROCESSING``): K = min(NMS_PRE_MAXSIZE, heads x
    MAX_OBJ_PER_SAMPLE) candidates a frame."""
    return batched_nms_candidates(
        forward_out["batch_box_preds"], forward_out["batch_score_preds"],
        forward_out["batch_label_preds"], forward_out["batch_valid_preds"],
        EasyDict(post_cfg).NMS_CONFIG)
