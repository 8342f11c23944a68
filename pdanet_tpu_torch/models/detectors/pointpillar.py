"""PointPillar detector: counterpart of ``pdanet_tpu/models/detectors/
pointpillar.py`` (``pcdet/models/detectors/pointpillar.py``): pillar VFE
-> scatter -> BEV backbone -> anchor head, all dense and channels-last.

The pillar budget is static (the host voxelizer's MAX_NUMBER_OF_VOXELS,
padded by the collate), so every tensor through the network has a fixed
shape.  Post-processing is IASSD's (``get_post_processor``): sigmoid,
score sort, the rotated self-IoU and the NMS walk over the
``NMS_PRE_MAXSIZE`` best anchors.

With ``VFE.NAME: DynamicPillarVFE`` the raw (B, N, 3 + C) cloud replaces
the pillar triplet (``DEVICE_BATCH_KEYS`` ``points`` and ``gt_boxes``, as
the JAX package's property resolves them): the VFE writes the BEV canvas
on the device, no pillar budget and no per-pillar cap.
"""

from ..backbones_2d.map_to_bev.pointpillar_scatter import pointpillar_scatter
from ..backbones_3d.vfe.dynamic_pillar_vfe import DynamicPillarVFE
from ..backbones_3d.vfe.pillar_vfe import PillarVFE
from .anchor_detector import AnchorDetector


class PointPillar(AnchorDetector):
    """MODEL.NAME: PointPillar, its grid from the dataset."""

    def __init__(self, model_cfg, num_class, input_channels=4, grid_size=None,
                 voxel_size=None, point_cloud_range=None, class_names=None):
        super().__init__(model_cfg, num_class, grid_size, voxel_size, point_cloud_range,
                         class_names)
        vfe_name = self.cfg.VFE.get("NAME", "PillarVFE")
        if vfe_name not in ("PillarVFE", "DynamicPillarVFE"):
            raise ValueError(f"VFE {vfe_name}: the JAX package's PointPillar builds PillarVFE "
                             f"or DynamicPillarVFE")
        self.dynamic_vfe = vfe_name == "DynamicPillarVFE"
        if self.dynamic_vfe:
            self.DEVICE_BATCH_KEYS = ("points", "gt_boxes")
            self.vfe = DynamicPillarVFE(self.cfg.VFE, input_channels, self.grid_size,
                                        voxel_size, point_cloud_range)
        else:
            self.vfe = PillarVFE(self.cfg.VFE, input_channels, voxel_size, point_cloud_range)
        self.build_head(self.cfg.MAP_TO_BEV.NUM_BEV_FEATURES)

    def forward(self, voxels, voxel_coords, voxel_num_points):
        """The voxel triplet (B, V, P, C), (B, V, 3) zyx with -1 pads and
        (B, V) -> the forward dict (:meth:`AnchorDetector.head_forward`).
        With the dynamic VFE ``voxels`` is the (B, N, 3 + C) cloud and the
        other two are None."""
        if self.dynamic_vfe:
            return self.head_forward(self.vfe(voxels))
        pillar_features = self.vfe(voxels, voxel_coords, voxel_num_points)
        return self.head_forward(pointpillar_scatter(pillar_features, voxel_coords,
                                                     self.grid_size))

    def forward_batch(self, batch):
        if self.dynamic_vfe:
            return self(batch["points"], None, None)
        return super().forward_batch(batch)
