"""PointPillar detector: counterpart of ``pdanet_tpu/models/detectors/
pointpillar.py`` (``pcdet/models/detectors/pointpillar.py``): pillar VFE
-> scatter -> BEV backbone -> anchor head, all dense and channels-last.

The pillar budget is static (the host voxelizer's MAX_NUMBER_OF_VOXELS,
padded by the collate), so every tensor through the network has a fixed
shape.  Post-processing is IASSD's (``get_post_processor``): sigmoid,
score sort, the rotated self-IoU and the NMS walk over the
``NMS_PRE_MAXSIZE`` best anchors.
"""

from ..backbones_2d.map_to_bev.pointpillar_scatter import pointpillar_scatter
from ..backbones_3d.vfe.pillar_vfe import PillarVFE
from .anchor_detector import AnchorDetector


class PointPillar(AnchorDetector):
    """MODEL.NAME: PointPillar, its grid from the dataset."""

    def __init__(self, model_cfg, num_class, input_channels=4, grid_size=None,
                 voxel_size=None, point_cloud_range=None, class_names=None):
        super().__init__(model_cfg, num_class, grid_size, voxel_size, point_cloud_range,
                         class_names)
        vfe_name = self.cfg.VFE.get("NAME", "PillarVFE")
        if vfe_name != "PillarVFE":
            raise NotImplementedError(f"VFE {vfe_name} is ROADMAP queue 1 item 9")
        self.vfe = PillarVFE(self.cfg.VFE, input_channels, voxel_size, point_cloud_range)
        self.build_head(self.cfg.MAP_TO_BEV.NUM_BEV_FEATURES)

    def forward(self, voxels, voxel_coords, voxel_num_points):
        """The voxel triplet (B, V, P, C), (B, V, 3) zyx with -1 pads and
        (B, V) -> the forward dict (:meth:`AnchorDetector.head_forward`)."""
        pillar_features = self.vfe(voxels, voxel_coords, voxel_num_points)
        return self.head_forward(pointpillar_scatter(pillar_features, voxel_coords,
                                                     self.grid_size))
