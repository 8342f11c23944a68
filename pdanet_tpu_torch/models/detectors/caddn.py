"""CaDDN: counterpart of ``pdanet_tpu/models/detectors/caddn.py``
(``pcdet/models/detectors/caddn.py``), camera-only 3-D detection: the
image VFE (the DDN's depth distributions -> the frustum -> the voxel grid)
-> Conv2DCollapse -> BaseBEVBackbone -> AnchorHeadSingle, the DDN's focal
depth loss added to the anchor losses.  Post-processing is IASSD's
(``get_post_processor``), the single-class NMS of the yaml.

The device batch is the collated camera inputs (``DEVICE_BATCH_KEYS``):
the (B, H, W, 3) images, the calibration matrices, and for the loss the
downsampled depth maps and the 2-D and 3-D gt boxes.
"""

from ..backbones_2d.map_to_bev.conv2d_collapse import Conv2DCollapse
from ..backbones_3d.vfe.image_vfe import ImageVFE, ddn_loss
from .anchor_detector import AnchorDetector


class CaDDN(AnchorDetector):
    """MODEL.NAME: CaDDN, its grid from the dataset (``calculate_grid_size``);
    ``input_channels`` is unused (the JAX package's too)."""

    DEVICE_BATCH_KEYS = ("images", "trans_lidar_to_cam", "trans_cam_to_img", "depth_maps",
                         "gt_boxes2d", "gt_boxes")

    def __init__(self, model_cfg, num_class, input_channels=3, grid_size=None,
                 voxel_size=None, point_cloud_range=None, class_names=None,
                 depth_downsample_factor=4):
        super().__init__(model_cfg, num_class, grid_size, voxel_size, point_cloud_range,
                         class_names)
        self.depth_downsample_factor = int(depth_downsample_factor)
        self.vfe = ImageVFE(self.cfg.VFE, self.grid_size, point_cloud_range,
                            self.depth_downsample_factor)
        c_voxel = int(self.cfg.VFE.FFN.CHANNEL_REDUCE["out_channels"])
        self.map_to_bev = Conv2DCollapse(self.cfg.MAP_TO_BEV, self.grid_size[2] * c_voxel)
        self.build_head(self.cfg.MAP_TO_BEV.NUM_BEV_FEATURES)

    def forward(self, images, lidar_to_cam, cam_to_img):
        """(B, H, W, 3) images in [0, 1], (B, 4, 4) and (B, 3, 4) matrices
        -> the forward dict (:meth:`AnchorDetector.head_forward`) with the
        ``depth_logits`` (B, H/4, W/4, D + 1)."""
        vfe_out = self.vfe(images, lidar_to_cam, cam_to_img)
        out = self.head_forward(self.map_to_bev(vfe_out["voxel_features"]))
        out["depth_logits"] = vfe_out["depth_logits"]
        return out

    def forward_batch(self, batch):
        return self(batch["images"], batch["trans_lidar_to_cam"], batch["trans_cam_to_img"])

    def loss(self, forward_out, gt_boxes, depth_maps=None, gt_boxes2d=None):
        """The anchor head's loss plus ``ddn_loss``: ``(loss, tb_dict)``."""
        rpn_loss, tb = super().loss(forward_out, gt_boxes)
        tb = dict(tb)
        ffn = self.cfg.VFE.FFN
        depth_loss, tb_d = ddn_loss(forward_out["depth_logits"], depth_maps, gt_boxes2d,
                                    dict(ffn.DISCRETIZE), ffn.LOSS,
                                    downsample_factor=self.depth_downsample_factor)
        tb.update(tb_d)
        total = rpn_loss + depth_loss
        tb["loss"] = total
        return total, tb

    def loss_batch(self, forward_out, batch):
        return self.loss(forward_out, batch["gt_boxes"], batch.get("depth_maps"),
                         batch.get("gt_boxes2d"))
