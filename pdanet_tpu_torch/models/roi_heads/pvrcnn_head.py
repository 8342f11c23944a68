"""PV-RCNN's RoI head: counterpart of
``pdanet_tpu/models/roi_heads/pvrcnn_head.py``
(``pcdet/models/roi_heads/pvrcnn_head.py``).  Each RoI's ``GRID_SIZE``^3
grid points (``get_dense_grid_points``) pool the keypoints' features: the
ball-query ``MaskedSAModuleMSG`` of the VSA (PV-RCNN), or VectorPool
(PV-RCNN++, ``ROI_GRID_POOL.NAME``); the flattened grid goes through the
shared, cls and reg FC stacks (Dense without bias, BatchNorm over every RoI
of the batch, ReLU).

The stacks and their dropout (JAX :66-82) are
``roi_head_template.RefineStacks``.  Module names are the flax ones
(``roi_grid_pool``, ``shared_fc0``, ``shared_bn0``, ``cls_pred`` ...).
"""

from ...utils.easydict import EasyDict
from ..backbones_3d.pfe.voxel_set_abstraction import make_aggregator
from .roi_head_template import RefineStacks
from .voxelrcnn_head import get_dense_grid_points


class PVRCNNHeadNet(RefineStacks):
    """RoI grid pooling and refinement (JAX :22-94) over keypoints of
    ``in_features`` channels."""

    def __init__(self, model_cfg, in_features, code_size, num_class=1):
        super().__init__()
        cfg = EasyDict(model_cfg)
        pool_cfg = EasyDict(cfg.ROI_GRID_POOL)
        self.grid = int(pool_cfg.GRID_SIZE)
        self.roi_grid_pool = make_aggregator(pool_cfg, in_features, "roi_grid_pool")
        self.build_stacks(cfg, self.grid ** 3 * self.roi_grid_pool.out_channels, code_size,
                          num_class)

    def pool(self, point_coords, point_features, rois):
        """The (B, R, g^3 * C) pooled grid of each RoI."""
        B, R = rois.shape[:2]
        grid_xyz = get_dense_grid_points(rois, self.grid).reshape(B, R * self.grid ** 3, 3)
        return self.roi_grid_pool(point_coords, point_features, grid_xyz).reshape(B, R, -1)

    def forward(self, point_coords, point_features, rois, keep=None):
        """point_coords (B, K, 3) keypoints, point_features (B, K, C) (weighted
        by the point head's foreground scores), rois (B, R, 7); ``keep`` in
        training with ``DP_RATIO`` -> ``rcnn_cls`` (B, R, num_class),
        ``rcnn_reg`` (B, R, code_size * num_class)."""
        return self.refine(self.pool(point_coords, point_features, rois), keep)
