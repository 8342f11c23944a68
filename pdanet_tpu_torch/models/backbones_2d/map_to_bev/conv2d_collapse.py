"""Conv2DCollapse: counterpart of ``pdanet_tpu/models/backbones_2d/
map_to_bev/conv2d_collapse.py`` (``pcdet/models/backbones_2d/map_to_bev/
conv2d_collapse.py``): CaDDN's map to BEV, the voxel grid's z axis folded
into the channels, then a 1 x 1 conv, BatchNorm (momentum 0.9, eps 1e-5)
and ReLU.

The fold is the JAX package's, channel ``z * C + c`` (the reference's is
``c * Z + z``), so that its ``block`` kernel maps over unchanged.
"""

import torch
from torch import nn

from ....utils.easydict import EasyDict
from ...blocks import BatchNorm, Conv


class Conv2DCollapse(nn.Module):
    """(B, Z, Y, X, C) voxel features -> (B, Y, X, NUM_BEV_FEATURES);
    ``in_features`` is Z * C."""

    def __init__(self, model_cfg, in_features):
        super().__init__()
        cfg = EasyDict(model_cfg)
        args = EasyDict(cfg.get("ARGS", {}))
        self.num_bev_features = int(cfg.NUM_BEV_FEATURES)
        self.block = Conv(in_features, self.num_bev_features, int(args.get("kernel_size", 1)),
                          stride=int(args.get("stride", 1)), bias=bool(args.get("bias", False)))
        self.bn = BatchNorm(self.num_bev_features)

    def forward(self, voxel_features):
        B, Z, Y, X, C = voxel_features.shape
        bev = voxel_features.permute(0, 2, 3, 1, 4).reshape(B, Y, X, Z * C)
        return torch.relu(self.bn(self.block(bev)))
