"""PV-RCNN's RoI head: counterpart of
``pdanet_tpu/models/roi_heads/pvrcnn_head.py``
(``pcdet/models/roi_heads/pvrcnn_head.py``).  Each RoI's ``GRID_SIZE``^3
grid points (``get_dense_grid_points``) pool the keypoints' features: the
ball-query ``MaskedSAModuleMSG`` of the VSA (PV-RCNN), or VectorPool
(PV-RCNN++, ``ROI_GRID_POOL.NAME``); the flattened grid goes through the
shared, cls and reg FC stacks (Dense without bias, BatchNorm over every RoI
of the batch, ReLU).

Dropout (``DP_RATIO``) follows the JAX package: the shared stack drops out
between its layers, the cls and reg stacks after their first layer (JAX
:66-82, the reference's ``make_fc_layers``).  It is flax's keep-and-scale
form, its keep masks a value the caller gives (:meth:`dropout_shapes`,
``roi_head_template.frame_draws``).  ``reg_pred`` starts from normal(0.001),
``cls_pred`` from flax's default.  Module names are the flax ones
(``roi_grid_pool``, ``shared_fc0``, ``shared_bn0``, ``cls_pred`` ...).
"""

import torch
from torch import nn

from ...utils.easydict import EasyDict
from ..backbones_3d.pfe.voxel_set_abstraction import make_aggregator
from ..blocks import BatchNorm, Dense
from .roi_head_template import dropout
from .voxelrcnn_head import get_dense_grid_points


class PVRCNNHeadNet(nn.Module):
    """RoI grid pooling and refinement (JAX :22-94) over keypoints of
    ``in_features`` channels."""

    def __init__(self, model_cfg, in_features, code_size, num_class=1):
        super().__init__()
        cfg = EasyDict(model_cfg)
        pool_cfg = EasyDict(cfg.ROI_GRID_POOL)
        self.grid = int(pool_cfg.GRID_SIZE)
        self.roi_grid_pool = make_aggregator(pool_cfg, in_features, "roi_grid_pool")
        self.dp = float(cfg.get("DP_RATIO", 0.0))
        self.stacks = {"shared": [int(f) for f in cfg.SHARED_FC],
                       "cls": [int(f) for f in cfg.CLS_FC], "reg": [int(f) for f in cfg.REG_FC]}
        c_in = {"shared": self.grid ** 3 * self.roi_grid_pool.out_channels}
        c_in["cls"] = c_in["reg"] = self.stacks["shared"][-1]
        for prefix, widths in self.stacks.items():
            c = c_in[prefix]
            for k, f in enumerate(widths):
                self.add_module(f"{prefix}_fc{k}", Dense(c, f, bias=False))
                self.add_module(f"{prefix}_bn{k}", BatchNorm(f))
                c = f
        self.cls_pred = Dense(self.stacks["cls"][-1], num_class)
        self.reg_pred = Dense(self.stacks["reg"][-1], code_size * num_class)
        with torch.no_grad():  # flax's normal(0.001), zero bias
            self.reg_pred.weight.normal_(0.0, 0.001)
            self.reg_pred.bias.zero_()

    def _drops(self, prefix):
        """The layers of a stack followed by dropout: between the shared
        stack's layers, after the first of cls and reg."""
        n = len(self.stacks[prefix])
        return [k for k in range(n) if (k != n - 1 if prefix == "shared" else k == 0)]

    def dropout_shapes(self, rois_per_frame):
        """``{name: (R, C)}``: the keep mask a frame that each dropout takes,
        ``<prefix><k>`` after layer k of a stack; none without ``DP_RATIO``."""
        if self.dp <= 0:
            return {}
        return {f"{prefix}{k}": (rois_per_frame, self.stacks[prefix][k])
                for prefix in self.stacks for k in self._drops(prefix)}

    def _stack(self, x, prefix, keep):
        drops = self._drops(prefix)
        for k in range(len(self.stacks[prefix])):
            x = torch.relu(getattr(self, f"{prefix}_bn{k}")(getattr(self, f"{prefix}_fc{k}")(x)))
            if k in drops and self.training and self.dp > 0:
                x = dropout(x, keep, f"{prefix}{k}", self.dp)
        return x

    def pool(self, point_coords, point_features, rois):
        """The (B, R, g^3 * C) pooled grid of each RoI."""
        B, R = rois.shape[:2]
        grid_xyz = get_dense_grid_points(rois, self.grid).reshape(B, R * self.grid ** 3, 3)
        return self.roi_grid_pool(point_coords, point_features, grid_xyz).reshape(B, R, -1)

    def refine(self, pooled, keep=None):
        """The FC stacks -> ``(rcnn_cls, rcnn_reg)``."""
        if self.training and self.dp > 0 and keep is None:
            raise ValueError("PVRCNNHeadNet: training with DP_RATIO takes the dropout keep "
                             "masks (train.make_train_step draws them)")
        shared = self._stack(pooled, "shared", keep)
        return (self.cls_pred(self._stack(shared, "cls", keep)),
                self.reg_pred(self._stack(shared, "reg", keep)))

    def forward(self, point_coords, point_features, rois, keep=None):
        """point_coords (B, K, 3) keypoints, point_features (B, K, C) (weighted
        by the point head's foreground scores), rois (B, R, 7); ``keep`` in
        training with ``DP_RATIO`` -> ``rcnn_cls`` (B, R, num_class),
        ``rcnn_reg`` (B, R, code_size * num_class)."""
        return self.refine(self.pool(point_coords, point_features, rois), keep)
