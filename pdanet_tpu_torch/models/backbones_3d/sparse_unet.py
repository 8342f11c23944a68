"""The sparse UNetV2: counterpart of ``pdanet_tpu/models/backbones_3d/
sparse_unet.py`` (``pcdet/models/backbones_3d/spconv_unet.py``, Part-A2's
encoder-decoder) over the gather-matmul engine, for the full-resolution
grids (0.05 m KITTI: 41 x 1600 x 1408 cells) that the dense UNet cannot
hold.

The encoder is ``SparseVoxelBackBone8x``'s ladder, its encoded BEV map
(``conv_out``) unless ``RETURN_ENCODED_TENSOR`` is False.  The decoder
runs UR blocks on each level's active set (``SparseURBlock``: a residual
block on the lateral, the concat with the stream from below, a
submanifold merge plus the pairwise channel-group sum) and upsamples by
the sparse inverse conv (``SparseInverseConv``, spconv's
SparseInverseConv3d): its output sites are exactly the finer level's
active set, its taps the coarse sites whose strided conv covered them
(``ops/sparse_conv.build_inverse_neighbor_table``, conv4's z padding 0
replayed).  So the stride-1 decoder output is row for row the input voxel
list: ``point_features`` (B, V, 16) needs no gather.

Parameter names are the flax ones: the encoder's as the sparse ladder's,
``inv_conv4.kernel`` (27, C_in, C_out) / ``inv_conv4.bn``, ``ur3.conv_up_t``
(``kernel1`` / ``bn1`` / ``kernel2`` / ``bn2``), ``ur3.conv_up_m``,
``conv5``.
"""

import torch
from torch import nn

from ...ops.sparse_conv import build_inverse_neighbor_table, gather_matmul_conv
from .sparse_backbone import (MaskedBatchNorm, SparseResBlock, SparseVoxelBackBone8x,
                              SubMConvBlock, sparse_kernel)
from .voxel_unet import channel_reduction


class SparseInverseConv(nn.Module):
    """The inverse conv (JAX :35-50): the gather-matmul over the inverse
    table, the masked BatchNorm on the fine rows, ReLU."""

    def __init__(self, c_in, features, taps=27):
        super().__init__()
        self.kernel = sparse_kernel(taps, c_in, features)
        self.bn = MaskedBatchNorm(features)

    def forward(self, coarse_feats, inv_tab, fine_valid):
        return torch.relu(self.bn(gather_matmul_conv(coarse_feats, inv_tab, self.kernel),
                                  fine_valid))


class SparseURBlock(nn.Module):
    """UR_block_forward (JAX :53-67) on one active set."""

    def __init__(self, c_lateral, c_bottom, c_mid):
        super().__init__()
        self.c_mid = c_mid
        self.conv_up_t = SparseResBlock(c_lateral, c_lateral)
        self.conv_up_m = SubMConvBlock(c_lateral + c_bottom, c_mid)

    def forward(self, lateral, bottom, nbr_idx, valid):
        x = torch.cat([bottom, self.conv_up_t(lateral, nbr_idx, valid)], dim=-1)
        return self.conv_up_m(x, nbr_idx, valid) + channel_reduction(x, self.c_mid)


class SparseUNetV2(SparseVoxelBackBone8x):
    """The sparse UNetV2 (JAX :70-200).  model_cfg: NUM_FILTERS ([16, 16, 32,
    64, 64]), NUM_OUTPUT_FEATURES (128), RETURN_ENCODED_TENSOR (True),
    ACTIVE_BUDGETS, SPCONV_ACTIVE_SETS, as the sparse ladder's.  Returns
    ``(bev, aux)``: the BEV map (None without the encoded tensor) and
    ``point_features`` (B, V, widths[1]), ``point_valid`` (B, V)."""

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__(model_cfg, input_channels, grid_size)
        w = self.widths
        self.ur4 = SparseURBlock(w[4], w[4], w[4])
        up = [w[4], w[2], w[1]]  # the inverse convs' widths, level 4 down
        mid = [w[3], w[2], w[1]]  # the UR blocks' after them
        c = w[4]
        for i, lvl in enumerate((2, 1, 0)):
            self.add_module(f"inv_conv{lvl + 2}", SparseInverseConv(c, up[i]))
            self.add_module(f"ur{lvl + 1}", SparseURBlock(w[lvl + 1], up[i], mid[i]))
            c = mid[i]
        self.conv5 = SubMConvBlock(c, w[1])

    def geometry(self, voxel_coords):
        """The sparse ladder's levels, each of levels 1-3 with ``inv``
        (B, n, 27): the inverse conv's taps into the level above it."""
        levels = super().geometry(voxel_coords)
        for lvl in (2, 1, 0):
            levels[lvl]["inv"] = build_inverse_neighbor_table(
                levels[lvl + 1]["coords"], self.grids[lvl + 1], levels[lvl]["coords"],
                padding=self.conv4_pad if lvl == 2 else None)
        return levels

    def forward(self, voxel_features, voxel_coords):
        levels = self.geometry(voxel_coords)
        feats = self.encode(voxel_features, levels)
        bev = self.encoded_bev(feats[3], levels[4]) if self.encoded else None
        top = levels[3]
        u = self.ur4(feats[3], feats[3], top["subm"], top["valid"])
        for lvl in (2, 1, 0):
            level = levels[lvl]
            u = getattr(self, f"inv_conv{lvl + 2}")(u, level["inv"], level["valid"])
            u = getattr(self, f"ur{lvl + 1}")(feats[lvl], u, level["subm"], level["valid"])
        valid = levels[0]["valid"]
        return bev, {"point_features": self.conv5(u, levels[0]["subm"], valid),
                     "point_valid": valid}
