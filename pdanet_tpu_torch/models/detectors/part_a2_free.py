"""Part-A2-free, the anchor-free Part-A2: counterpart of
``pdanet_tpu/models/detectors/part_a2_free.py`` (the reference's
``PartA2_free.yaml``, which names the PointRCNN detector over voxel
components).  MeanVFE, the sparse or dense UNetV2 without the encoded BEV
map, the intra-part head with its per-voxel box branch (the
``PointResidualCoder``), whose decoded boxes are the proposals (padding
rows' logits at -1e9, so that they do not propose), and the RoI-aware
refinement with ``DISABLE_PART`` (the voxel centres pooled in place of the
part offsets).  The loss is the point loss (with the box term) and the
RCNN loss.
"""

from torch import nn

from ...utils.box_coder_utils import build_box_coder
from ...utils.easydict import EasyDict
from ..backbones_3d.sparse_unet import SparseUNetV2
from ..backbones_3d.vfe.mean_vfe import MeanVFE
from ..backbones_3d.voxel_unet import UNetV2
from ..dense_heads.point_head_box import generate_predicted_boxes
from .part_a2 import PartA2Refine
from .second import SECOND

UNETS = {"UNetV2": UNetV2, "SparseUNetV2": SparseUNetV2}


class PartA2Free(PartA2Refine, nn.Module):
    """Part-A2-free (JAX :27-191), its grid from the dataset
    (``build_network(..., dataset=...)``)."""

    DEVICE_BATCH_KEYS = SECOND.DEVICE_BATCH_KEYS

    def __init__(self, model_cfg, num_class, input_channels=4, grid_size=None,
                 voxel_size=None, point_cloud_range=None, class_names=None):
        super().__init__()
        if grid_size is None or voxel_size is None or point_cloud_range is None \
                or class_names is None:
            raise ValueError("PartA2Free takes its grid from the dataset: "
                             "build_network(..., dataset=...)")
        self.cfg = EasyDict(model_cfg)
        self.num_class = num_class
        self.grid_size = tuple(int(g) for g in grid_size)
        self.point_cloud_range = point_cloud_range
        self.class_names = list(class_names)
        self.vfe = MeanVFE(self.cfg.get("VFE"), input_channels)
        b3d_cfg = self.cfg.get("BACKBONE_3D", {})
        unet = UNETS[b3d_cfg.get("NAME", "UNetV2")]
        self.backbone_3d = unet(b3d_cfg, input_channels, self.grid_size)
        target_cfg = self.cfg.POINT_HEAD.TARGET_CONFIG
        self.point_box_coder = build_box_coder(target_cfg.BOX_CODER,
                                               target_cfg.get("BOX_CODER_CONFIG", {}))
        self.build_refine(self.cfg, num_class, voxel_size, self.point_box_coder)

    def first_stage(self, voxels, voxel_coords, voxel_num_points):
        """The intra-part head's outputs over the UNet, its boxes decoded
        (``batch_box_preds``) and its logits, -1e9 on padding rows
        (``batch_cls_preds``)."""
        _, aux = self.backbone_3d(self.vfe(voxels, voxel_num_points), voxel_coords)
        out = self.point_stage(aux, voxel_coords)
        _, boxes = generate_predicted_boxes(out["point_coords"], out["point_cls_preds"],
                                            out["point_box_preds"], self.point_box_coder)
        masked = out["point_cls_preds"].masked_fill(~out["point_valid"][..., None], -1e9)
        out.update(batch_cls_preds=masked, batch_box_preds=boxes)
        return out

    def loss(self, forward_out, gt_boxes):
        """The intra-part loss with its box term and the RCNN loss: ``(loss,
        tb_dict)``."""
        point_loss, tb = self.point_loss(forward_out, gt_boxes, self.point_box_coder)
        rcnn_loss, tb_r = self.rcnn_loss(forward_out)
        tb = dict(tb)
        tb.update(tb_r)
        return point_loss + rcnn_loss, tb

    def loss_batch(self, forward_out, batch):
        return self.loss(forward_out, batch["gt_boxes"])
