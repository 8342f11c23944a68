"""BEV CNN backbone: counterpart of ``pdanet_tpu/models/backbones_2d/
base_bev_backbone.py`` (``pcdet/models/backbones_2d/base_bev_backbone.py``):
per level a strided 3x3 conv block, then an upsampling transposed conv
(or, for a stride below 1, a strided conv), the levels' outputs
concatenated.  Channels-last (B, H, W, C) throughout; the convolutions are
``F.conv2d`` / ``F.conv_transpose2d`` (``blocks.Conv``,
``blocks.ConvTranspose``), as the JAX package computes them with XLA's
convolution outside any Pallas kernel."""

import numpy as np
import torch
from torch import nn

from ...utils.easydict import EasyDict
from ..blocks import BatchNorm, Conv, ConvTranspose

BN_EPS = 1e-3
BN_MOMENTUM = 0.99  # flax 0.99: the reference's torch momentum 0.01 (base_bev_backbone.py:37)


class ConvBNReLU(nn.Module):
    """3x3 conv (padding 1, no bias) -> BatchNorm -> ReLU."""

    def __init__(self, in_features, features, stride=1, bn_momentum=BN_MOMENTUM):
        super().__init__()
        self.conv = Conv(in_features, features, 3, stride=stride, padding=(1, 1), bias=False)
        self.bn = BatchNorm(features, eps=BN_EPS, momentum=bn_momentum)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class BaseBEVBackbone(nn.Module):
    """model_cfg keys: LAYER_NUMS, LAYER_STRIDES, NUM_FILTERS,
    UPSAMPLE_STRIDES, NUM_UPSAMPLE_FILTERS, BN_MOMENTUM (flax's, 0.99)."""

    def __init__(self, model_cfg, input_channels):
        super().__init__()
        cfg = EasyDict(model_cfg)
        self.layer_nums = list(cfg.get("LAYER_NUMS", []) or [])
        layer_strides = list(cfg.get("LAYER_STRIDES", []) or [])
        num_filters = list(cfg.get("NUM_FILTERS", []) or [])
        self.upsample_strides = list(cfg.get("UPSAMPLE_STRIDES", []) or [])
        num_up_filters = list(cfg.get("NUM_UPSAMPLE_FILTERS", []) or [])
        bn_m = float(cfg.get("BN_MOMENTUM", BN_MOMENTUM))

        c_in = input_channels
        c_out = 0
        self.up_names = []
        for idx, n in enumerate(self.layer_nums):
            self.add_module(f"blocks_{idx}_down", ConvBNReLU(
                c_in, num_filters[idx], layer_strides[idx], bn_m))
            for k in range(n):
                self.add_module(f"blocks_{idx}_{k}", ConvBNReLU(
                    num_filters[idx], num_filters[idx], 1, bn_m))
            c_in = num_filters[idx]
            if not self.upsample_strides:
                c_out += c_in
                continue
            stride = self.upsample_strides[idx]
            if stride >= 1:
                name = f"deblocks_{idx}_deconv"
                up = ConvTranspose(c_in, num_up_filters[idx], int(stride), int(stride),
                                   bias=False)
            else:
                s = int(np.round(1 / stride))
                name = f"deblocks_{idx}_conv"
                up = Conv(c_in, num_up_filters[idx], s, stride=s, bias=False)
            self.add_module(name, up)
            self.add_module(f"deblocks_{idx}_bn", BatchNorm(
                num_up_filters[idx], eps=BN_EPS, momentum=bn_m))
            self.up_names.append(name)
            c_out += num_up_filters[idx]
        self.final = len(self.upsample_strides) > len(self.layer_nums)
        if self.final:
            s = int(self.upsample_strides[-1])
            self.deblocks_final_deconv = ConvTranspose(c_out, c_out, s, s, bias=False)
            self.deblocks_final_bn = BatchNorm(c_out, eps=BN_EPS, momentum=bn_m)
        self.num_bev_features = c_out

    def forward(self, x):
        """x (B, ny, nx, C) -> (B, H', W', num_bev_features)."""
        ups = []
        for idx, n in enumerate(self.layer_nums):
            x = getattr(self, f"blocks_{idx}_down")(x)
            for k in range(n):
                x = getattr(self, f"blocks_{idx}_{k}")(x)
            if self.upsample_strides:
                u = getattr(self, self.up_names[idx])(x)
                ups.append(torch.relu(getattr(self, f"deblocks_{idx}_bn")(u)))
            else:
                ups.append(x)
        out = torch.cat(ups, dim=-1) if len(ups) > 1 else ups[0]
        if self.final:
            out = torch.relu(self.deblocks_final_bn(self.deblocks_final_deconv(out)))
        return out
