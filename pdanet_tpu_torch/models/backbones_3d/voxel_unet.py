"""The dense UNetV2: counterpart of ``pdanet_tpu/models/backbones_3d/
voxel_unet.py`` (``pcdet/models/backbones_3d/spconv_unet.py``, Part-A2's
encoder-decoder) over the dense ladder of ``voxel_backbone.py``.

The encoder is ``VoxelBackBone8x``'s ladder at fixed widths (16, 16, 32,
64, 64), with the encoded BEV map (``conv_out``, 128 channels) unless
``RETURN_ENCODED_TENSOR`` is False (Part-A2-free).  The decoder runs UR
blocks back up to stride 1: a residual block on the lateral, the concat
with the stream from below, a merge conv plus the pairwise channel-group
sum (``channel_reduction``), then a transposed 3x3x3 stride-2 conv
(``inv_conv``) cropped to the lateral's dims.  Every BatchNorm is the
masked one at eps 1e-3 and flax momentum 0.99, every level's active cells
the encoder's (an inverse conv outputs the set its downsample consumed).
The decoder's stride-1 output is read back at the input voxels
(``gather_from_dense``): ``point_features`` (B, V, 16).  Over a dynamic
VFE's pre-scattered grid there is no voxel list: ``point_features`` is then
the whole (B, Z, Y, X, 16) stride-1 grid and ``point_valid`` its active
cells (the JAX package's read-back fails there; ROADMAP queue 3).

The transposed convs are flax's ``ConvTranspose`` (``transpose_kernel``
False) with (lo, hi) padding (1, 2), or (2, 3) on conv4's z, which
inverts its z padding 0 (``blocks.ConvTranspose3d``).  Parameter names
are the flax ones (``inv_conv4.ConvTranspose_0``, ``ur3.conv_up_t.conv1``,
``ur3.conv_up_m.Conv_0`` ...).
"""

import torch
from torch import nn

from ..blocks import ConvTranspose3d
from .voxel_backbone import (Conv3DBNReLU, DenseMaskedBatchNorm, ResBlock3D,
                             _cells, _DenseBackbone8x)


def gather_from_dense(grid, voxel_coords):
    """The (B, V, C) rows of the (B, C, Z, Y, X) ``grid`` at the (B, V, 3)
    zyx ``voxel_coords`` (JAX :35-52), each coordinate clipped into the
    grid, a padding row (z < 0) zero."""
    B, C, Z, Y, X = grid.shape
    coords = voxel_coords.long()
    valid = coords[..., 0] >= 0
    zs = coords[..., 0].clamp(0, Z - 1)
    ys = coords[..., 1].clamp(0, Y - 1)
    xs = coords[..., 2].clamp(0, X - 1)
    flat = (zs * Y + ys) * X + xs
    out = torch.gather(_cells(grid), 1, flat[..., None].expand(-1, -1, C))
    return torch.where(valid[..., None], out, 0.0)


def channel_reduction(x, out_channels, dim=-1):
    """The pairwise channel-group sum of axis ``dim`` (JAX :55-61,
    spconv_unet.py:146-161): channel o * r + j of C_in = out_channels * r
    adds into o."""
    d = dim % x.dim()
    c_in = x.shape[d]
    if c_in % out_channels:
        raise ValueError(f"channel_reduction: {c_in} channels into {out_channels}")
    shape = x.shape[:d] + (out_channels, c_in // out_channels) + x.shape[d + 1:]
    return x.reshape(shape).sum(dim=d + 1)


class UpConv3D(nn.Module):
    """The inverse conv (JAX :64-92): a transposed 3x3x3 stride-2 conv, no
    bias, cropped to ``target`` (Z, Y, X), then the masked BatchNorm and
    ReLU on the finer level's active cells."""

    def __init__(self, c_in, features, padding=((1, 2), (1, 2), (1, 2))):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose3d(c_in, features, (3, 3, 3), 2, padding)
        self.BatchNorm_0 = DenseMaskedBatchNorm(features)

    def forward(self, x, target, occ):
        Z, Y, X = target
        x = self.ConvTranspose_0(x)[:, :, :Z, :Y, :X].contiguous()
        return self.BatchNorm_0(x, occ)


class URBlock(nn.Module):
    """UR_block_forward (JAX :95-108): ``conv_up_t`` residual block on the
    lateral, concat ``[bottom, that]``, ``conv_up_m`` merge plus the
    channel reduction of the concat."""

    def __init__(self, c_lateral, c_bottom, c_mid):
        super().__init__()
        self.c_mid = c_mid
        self.conv_up_t = ResBlock3D(c_lateral)
        self.conv_up_m = Conv3DBNReLU(c_lateral + c_bottom, c_mid)

    def forward(self, lateral, bottom, occ):
        x = torch.cat([bottom, self.conv_up_t(lateral, occ)], dim=1)
        return self.conv_up_m(x, occ) + channel_reduction(x, self.c_mid, dim=1)


class UNetV2(_DenseBackbone8x):
    """The dense UNetV2 (JAX :111-179).  model_cfg: RETURN_ENCODED_TENSOR
    (True), SUBMANIFOLD_MASKING (True).  Returns ``(bev, aux)``: the (B,
    Y/8, X/8, Zo * 128) BEV map (None without the encoded tensor) and
    ``point_features`` (B, V, 16), ``point_valid`` (B, V)."""

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__(model_cfg, grid_size)
        self.encoded = bool(self.cfg.get("RETURN_ENCODED_TENSOR", True))
        self.widths = [16, 16, 32, 64, 64]
        self.conv_input = Conv3DBNReLU(input_channels, 16)
        self.conv1 = Conv3DBNReLU(16, 16)
        for lvl, (c_in, c) in ((2, (16, 32)), (3, (32, 64)), (4, (64, 64))):
            pad = (self.pad4, 1, 1) if lvl == 4 else None
            self.add_module(f"conv{lvl}_down", Conv3DBNReLU(c_in, c, stride=(2, 2, 2),
                                                            padding=pad))
            for suf in ("a", "b"):
                self.add_module(f"conv{lvl}_{suf}", Conv3DBNReLU(c, c))
        if self.encoded:
            self.conv_out = Conv3DBNReLU(64, 128, kernel=(3, 1, 1), stride=(2, 1, 1),
                                         padding=(self.pad_out, 0, 0))
        self.num_bev_features = self.z_chain[4] * 128 if self.encoded else 0
        z4_inv = (2, 3) if self.pad4 == 0 else (1, 2)
        self.ur4 = URBlock(64, 64, 64)
        self.inv_conv4 = UpConv3D(64, 64, padding=(z4_inv, (1, 2), (1, 2)))
        self.ur3 = URBlock(64, 64, 64)
        self.inv_conv3 = UpConv3D(64, 32)
        self.ur2 = URBlock(32, 32, 32)
        self.inv_conv2 = UpConv3D(32, 16)
        self.ur1 = URBlock(16, 16, 16)
        self.conv5 = Conv3DBNReLU(16, 16)

    def forward(self, voxel_features, voxel_coords):
        x, occs = self.grid(voxel_features, voxel_coords)
        active = None if voxel_coords is not None else (x != 0).any(dim=1)
        x1 = self.conv1(self.conv_input(x, occs[0]), occs[0])
        levels = [x1]
        for lvl in (2, 3, 4):
            occ = occs[lvl - 1]
            x = getattr(self, f"conv{lvl}_down")(levels[-1], occ)
            x = getattr(self, f"conv{lvl}_a")(x, occ)
            levels.append(getattr(self, f"conv{lvl}_b")(x, occ))
        x1, x2, x3, x4 = levels
        bev = self.compress(self.conv_out(x4, occs[4])) if self.encoded else None
        u = self.ur4(x4, x4, occs[3])
        u = self.ur3(x3, self.inv_conv4(u, x3.shape[2:], occs[2]), occs[2])
        u = self.ur2(x2, self.inv_conv3(u, x2.shape[2:], occs[1]), occs[1])
        u = self.ur1(x1, self.inv_conv2(u, x1.shape[2:], occs[0]), occs[0])
        x_up1 = self.conv5(u, occs[0])
        if voxel_coords is None:
            return bev, {"point_features": x_up1.permute(0, 2, 3, 4, 1), "point_valid": active}
        aux = {"point_features": gather_from_dense(x_up1, voxel_coords),
               "point_valid": voxel_coords[..., 0] >= 0}
        return bev, aux
