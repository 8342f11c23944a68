"""SECOND detector: counterpart of ``pdanet_tpu/models/detectors/second.py``
(``pcdet/models/detectors/second_net.py``): MeanVFE -> a 3-D voxel
backbone with the height compression folded in -> BEV backbone -> the
single or multi-group anchor head.

With ``VFE.NAME: DynamicMeanVFE`` the raw (B, N, 3 + C) cloud replaces the
voxel triplet (``DEVICE_BATCH_KEYS`` ``points`` and ``gt_boxes``, as the
JAX package's property resolves them from the config): the VFE writes the
dense mean grid on the device and a dense 3-D backbone (``VoxelBackBone8x``,
``VoxelResBackBone8x``, ``UNetV2``) takes it without a voxel list.  The
sparse backbones need the list; with a dynamic VFE they raise, where the
JAX package fails inside its trace.

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
from ..backbones_3d.vfe.dynamic_mean_vfe import DynamicMeanVFE
from ..backbones_3d.vfe.mean_vfe import MeanVFE
from ..backbones_3d.voxel_backbone import VoxelBackBone8x, VoxelResBackBone8x
from ..backbones_3d.voxel_unet import UNetV2
from .anchor_detector import AnchorDetector

BACKBONES_3D = {"VoxelBackBone8x": VoxelBackBone8x, "VoxelResBackBone8x": VoxelResBackBone8x,
                "SparseVoxelBackBone8x": SparseVoxelBackBone8x,
                "SparseVoxelResBackBone8x": SparseVoxelResBackBone8x,
                "UNetV2": UNetV2, "SparseUNetV2": SparseUNetV2}
DENSE_GRID_BACKBONES = ("VoxelBackBone8x", "VoxelResBackBone8x", "UNetV2")


class SECOND(AnchorDetector):
    """MODEL.NAME: SECOND, its grid from the dataset."""

    def __init__(self, model_cfg, num_class, input_channels=4, grid_size=None,
                 voxel_size=None, point_cloud_range=None, class_names=None):
        super().__init__(model_cfg, num_class, grid_size, voxel_size, point_cloud_range,
                         class_names)
        vfe_name = (self.cfg.get("VFE") or {}).get("NAME", "MeanVFE")
        if vfe_name not in ("MeanVFE", "DynamicMeanVFE"):
            raise ValueError(f"VFE {vfe_name}: the JAX package's SECOND builds MeanVFE or "
                             f"DynamicMeanVFE")
        b3d_cfg = self.cfg.get("BACKBONE_3D", {})
        b3d_name = b3d_cfg.get("NAME", "VoxelBackBone8x")
        if b3d_name not in BACKBONES_3D:
            raise ValueError(f"3-D backbone {b3d_name}: the JAX package has "
                             f"{', '.join(BACKBONES_3D)}")
        self.dynamic_vfe = vfe_name == "DynamicMeanVFE"
        if self.dynamic_vfe:
            if type(self) is not SECOND:  # the JAX package's forward_batch reads voxels
                raise ValueError(f"{type(self).__name__} takes the voxel triplet, not a "
                                 f"dynamic VFE's cloud")
            if b3d_name not in DENSE_GRID_BACKBONES:
                raise ValueError(f"DynamicMeanVFE writes a dense grid: {b3d_name} takes a "
                                 f"voxel list (dense ones: {', '.join(DENSE_GRID_BACKBONES)})")
            self.DEVICE_BATCH_KEYS = ("points", "gt_boxes")
            self.vfe = DynamicMeanVFE(self.cfg.get("VFE"), input_channels, self.grid_size,
                                      voxel_size, point_cloud_range)
        else:
            self.vfe = MeanVFE(self.cfg.get("VFE"), input_channels)
        self.backbone_3d = BACKBONES_3D[b3d_name](b3d_cfg, input_channels, self.grid_size)
        self.build_head(self.backbone_3d.num_bev_features)

    def forward(self, voxels, voxel_coords, voxel_num_points):
        """The voxel triplet (B, V, P, C), (B, V, 3) zyx with -1 pads and
        (B, V) -> the forward dict (:meth:`AnchorDetector.head_forward`),
        with the 3-D backbone's ``multi_scale_3d_features``.  With the
        dynamic VFE ``voxels`` is the (B, N, 3 + C) cloud and the other two
        are None."""
        if self.dynamic_vfe:
            spatial, multi_scale = self.backbone_3d(self.vfe(voxels), None)
        else:
            spatial, multi_scale = self.backbone_3d(self.vfe(voxels, voxel_num_points),
                                                    voxel_coords)
        out = self.head_forward(spatial)
        out["multi_scale_3d_features"] = multi_scale
        return out

    def forward_batch(self, batch):
        if self.dynamic_vfe:
            return self(batch["points"], None, None)
        return super().forward_batch(batch)
