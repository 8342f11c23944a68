"""SECOND detector: counterpart of ``pdanet_tpu/models/detectors/second.py``
(``pcdet/models/detectors/second_net.py``): MeanVFE -> a 3-D voxel
backbone with the height compression folded in -> BEV backbone -> the
single or multi-group anchor head.

The 3-D backbones are the gather-matmul ones (``SparseVoxelBackBone8x``,
``SparseVoxelResBackBone8x``) that the shipped ``second.yaml`` names, the
dense ones (``VoxelBackBone8x``, ``VoxelResBackBone8x``) of
``second_iou.yaml`` and ``second_multihead.yaml``, and the UNetV2s of
Part-A2 (``SparseUNetV2``, ``UNetV2``), all at the 0.05 m grid.  The BEV map's channel count is the backbone's own (z sites of the
last level times NUM_OUTPUT_FEATURES), which flax infers and
MAP_TO_BEV.NUM_BEV_FEATURES states.  Post-processing is IASSD's
(``get_post_processor``), as for PointPillar; with ``MULTI_CLASSES_NMS``
its per-class NMS.
"""

from ..backbones_3d.sparse_backbone import SparseVoxelBackBone8x, SparseVoxelResBackBone8x
from ..backbones_3d.sparse_unet import SparseUNetV2
from ..backbones_3d.vfe.mean_vfe import MeanVFE
from ..backbones_3d.voxel_backbone import VoxelBackBone8x, VoxelResBackBone8x
from ..backbones_3d.voxel_unet import UNetV2
from .anchor_detector import AnchorDetector

BACKBONES_3D = {"VoxelBackBone8x": VoxelBackBone8x, "VoxelResBackBone8x": VoxelResBackBone8x,
                "SparseVoxelBackBone8x": SparseVoxelBackBone8x,
                "SparseVoxelResBackBone8x": SparseVoxelResBackBone8x,
                "UNetV2": UNetV2, "SparseUNetV2": SparseUNetV2}


class SECOND(AnchorDetector):
    """MODEL.NAME: SECOND, its grid from the dataset.  The dynamic VFE and
    the ATSS assigner of the JAX package raise (ROADMAP queue 1 item 9)."""

    def __init__(self, model_cfg, num_class, input_channels=4, grid_size=None,
                 voxel_size=None, point_cloud_range=None, class_names=None):
        super().__init__(model_cfg, num_class, grid_size, voxel_size, point_cloud_range,
                         class_names)
        vfe_name = (self.cfg.get("VFE") or {}).get("NAME", "MeanVFE")
        if vfe_name != "MeanVFE":
            raise NotImplementedError(f"VFE {vfe_name} is ROADMAP queue 1 item 9")
        b3d_cfg = self.cfg.get("BACKBONE_3D", {})
        b3d_name = b3d_cfg.get("NAME", "VoxelBackBone8x")
        if b3d_name not in BACKBONES_3D:
            raise NotImplementedError(f"3-D backbone {b3d_name} is ROADMAP queue 1 item 9")
        self.vfe = MeanVFE(self.cfg.get("VFE"), input_channels)
        self.backbone_3d = BACKBONES_3D[b3d_name](b3d_cfg, input_channels, self.grid_size)
        self.build_head(self.backbone_3d.num_bev_features)

    def forward(self, voxels, voxel_coords, voxel_num_points):
        """The voxel triplet (B, V, P, C), (B, V, 3) zyx with -1 pads and
        (B, V) -> the forward dict (:meth:`AnchorDetector.head_forward`),
        with the 3-D backbone's ``multi_scale_3d_features``."""
        spatial, multi_scale = self.backbone_3d(self.vfe(voxels, voxel_num_points),
                                                voxel_coords)
        out = self.head_forward(spatial)
        out["multi_scale_3d_features"] = multi_scale
        return out
