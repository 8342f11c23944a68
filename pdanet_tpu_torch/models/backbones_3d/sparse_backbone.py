"""Sparse voxel backbones: counterpart of ``pdanet_tpu/models/backbones_3d/
sparse_backbone.py`` (``spconv_backbone.VoxelBackBone8x`` and
``VoxelResBackBone8x`` of the reference) over the gather-matmul engine of
``ops/sparse_conv.py``, for full-resolution grids (0.05 m KITTI: 41 x
1600 x 1408 cells) whose dense form cannot be held.

The ladder of the reference: conv_input and conv1 (stride 1), then three
strided downs (conv2-conv4, conv4 with z padding 0) each followed by two
submanifold blocks, then the z-compressing ``conv_out`` ((3, 1, 1),
stride (2, 1, 1), ``last_pad`` 0), under static per-level active-site
budgets (``ACTIVE_BUDGETS``, V at every level by default).  The index
work of a level (its active sites, the neighbour table its submanifold
convs share, the table of the strided conv that made it) depends on the
coordinates alone: :meth:`geometry` computes it for every level, and the
forward runs the convs over it.  Only the last level is scattered
densely; that scatter folds in the reference's HeightCompression, with the
JAX package's Zo-major channel order ``(B, Zo, Y, X, C)`` -> ``(B, Y, X,
Zo * C)``.

Parameter names are the flax ones: a block's ``kernel`` (or ``kernel1`` /
``kernel2``), the backbone's ``conv2_down_kernel`` ... ``conv_out_kernel``,
all in flax's (K, C_in, C_out) layout, and ``bn`` / ``bn1`` / ``conv2_down_bn``
... for the masked BatchNorms.
"""

import math

import torch
from torch import nn

from ... import parallel
from ...ops.sparse_conv import (
    build_neighbor_table,
    downsample_coords,
    gather_matmul_conv,
    stage_grids,
)
from ...utils.easydict import EasyDict
from ..blocks import BatchNorm


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over the valid rows of a (B, V, C) sparse feature list
    (JAX :35-70; spconv's BatchNorm1d runs on the active-site list):
    padding rows feed neither the statistics nor the running averages, and
    come out zero.  Momentum 0.99 and eps 1e-3 (flax's); the running
    variance takes the unbiased variance over the valid-row count n.

    In a process group the training moments are those of the global batch,
    as the JAX package's GSPMD sums give them: each rank's count of valid
    rows differs, so the count is all-reduced together with the sum of x,
    then the sum of squares about the global mean."""

    def __init__(self, channels, eps=1e-3, momentum=0.99):
        super().__init__(channels, eps=eps, momentum=momentum)

    def forward(self, x, valid):
        ct = torch.promote_types(x.dtype, self.weight.dtype)
        xc = x.to(ct)
        if self.training:
            w = valid.to(ct)[..., None]
            total = parallel.all_reduce_sum(
                torch.cat([(xc * w).sum(dim=(0, 1)), w.sum().reshape(1)]))
            n = total[-1].detach().clamp(min=1.0)
            mean = total[:-1] / n
            centred = xc - mean
            var = parallel.all_reduce_sum((w * centred * centred).sum(dim=(0, 1))) / n
            with torch.no_grad():
                unbiased = var * (n / (n - 1.0).clamp(min=1.0))
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * unbiased)
        else:
            centred = xc - self.running_mean
            var = self.running_var
        y = centred * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return torch.where(valid[..., None], y, 0.0)


def sparse_kernel(taps, c_in, c_out):
    """A sparse conv kernel (taps, C_in, C_out) in flax's layout, drawn as
    the JAX package's ``variance_scaling(2.0, "fan_in")``: std
    sqrt(2 / (taps * C_in))."""
    return nn.Parameter(torch.randn(taps, c_in, c_out) * math.sqrt(2.0 / (taps * c_in)))


class SubMConvBlock(nn.Module):
    """Submanifold conv -> masked BatchNorm -> ReLU (post_act_block 'subm')."""

    def __init__(self, c_in, features, kernel=(3, 3, 3)):
        super().__init__()
        self.kernel = sparse_kernel(math.prod(kernel), c_in, features)
        self.bn = MaskedBatchNorm(features)

    def forward(self, feats, nbr_idx, valid):
        return torch.relu(self.bn(gather_matmul_conv(feats, nbr_idx, self.kernel), valid))


class SparseResBlock(nn.Module):
    """SparseBasicBlock (spconv_backbone.py:121-160): two submanifold convs,
    the identity residual, ReLU after it; padding rows zero."""

    def __init__(self, c_in, features, kernel=(3, 3, 3)):
        super().__init__()
        taps = math.prod(kernel)
        self.kernel1 = sparse_kernel(taps, c_in, features)
        self.bn1 = MaskedBatchNorm(features)
        self.kernel2 = sparse_kernel(taps, features, features)
        self.bn2 = MaskedBatchNorm(features)

    def forward(self, feats, nbr_idx, valid):
        h = torch.relu(self.bn1(gather_matmul_conv(feats, nbr_idx, self.kernel1), valid))
        h = self.bn2(gather_matmul_conv(h, nbr_idx, self.kernel2), valid)
        return torch.where(valid[..., None], torch.relu(h + feats), 0.0)


class _SparseBackbone8x(nn.Module):
    """What both backbones share: the stage geometry, the strided downs,
    ``conv_out`` and the BEV scatter.  A subclass registers its blocks and
    lists their names a level in ``self.level_blocks``.

    model_cfg keys: NUM_FILTERS, NUM_OUTPUT_FEATURES (128), ACTIVE_BUDGETS
    (four per-level caps, V each by default; the first is unused, the
    fourth also caps ``conv_out``), SPCONV_ACTIVE_SETS (True: spconv's
    exact output sets; False: the centre-tap sites), RETURN_ENCODED_TENSOR
    (True; False, the sparse UNet of Part-A2-free: no ``conv_out``)."""

    def __init__(self, model_cfg, grid_size, default_filters):
        super().__init__()
        cfg = EasyDict(model_cfg)
        self.encoded = bool(cfg.get("RETURN_ENCODED_TENSOR", True))
        self.widths = list(cfg.get("NUM_FILTERS", default_filters))
        self.c_out = int(cfg.get("NUM_OUTPUT_FEATURES", 128))
        budgets = cfg.get("ACTIVE_BUDGETS")
        self.budgets = None if budgets is None else [int(b) for b in budgets]
        self.dilate = bool(cfg.get("SPCONV_ACTIVE_SETS", True))
        self.grids, self.conv4_pad = stage_grids(grid_size)
        z4 = self.grids[3][2]
        self.zo_ref = z4 >= 3  # the reference's last_pad 0, or the tiny-grid fallback
        self.Zo = max((z4 - 1) // 2 if self.zo_ref else (z4 + 1) // 2, 1)
        self.num_bev_features = self.Zo * self.c_out if self.encoded else 0
        for lvl in (1, 2, 3):
            self.register_parameter(f"conv{lvl + 1}_down_kernel", sparse_kernel(
                27, self.widths[lvl], self.widths[lvl + 1]))
            self.add_module(f"conv{lvl + 1}_down_bn", MaskedBatchNorm(self.widths[lvl + 1]))
        if self.encoded:
            self.conv_out_kernel = sparse_kernel(3, self.widths[4], self.c_out)
            self.conv_out_bn = MaskedBatchNorm(self.c_out)

    def geometry(self, voxel_coords):
        """The index work of every level from the (B, V, 3) zyx voxel
        coordinates (-1 padded): a list of five dicts, levels 1-4 and
        ``conv_out`` (four without the encoded tensor), each with its active
        sites ``coords`` (B, n, 3) int32, ``valid`` (B, n), and its neighbour
        tables (int32, -1 absent):
        ``subm`` (B, n, 27), shared by the level's submanifold convs (not
        at ``conv_out``), and ``down`` (B, n, 27 or 3), the strided conv's
        taps into the level below (not at level 1)."""
        g = self.grids
        V = voxel_coords.shape[1]
        budgets = self.budgets or [V] * 4
        coords = voxel_coords
        levels = [dict(coords=coords, subm=build_neighbor_table(coords, g[0]))]
        for lvl in (1, 2, 3):
            gx, gy, gz = g[lvl]
            pad = self.conv4_pad if lvl == 3 else None
            out = downsample_coords(coords, budgets[lvl], out_grid=(gz, gy, gx),
                                    dilate=self.dilate, padding=pad or (1, 1, 1))
            down = build_neighbor_table(coords, g[lvl - 1], query_coords=out, stride=(2, 2, 2),
                                        padding=pad)
            levels.append(dict(coords=out, down=down, subm=build_neighbor_table(out, g[lvl])))
            coords = out
        if self.encoded:
            levels.append(self._out_level(coords, budgets[3]))
        for level in levels:
            level["valid"] = (level["coords"] >= 0).all(dim=-1)
        return levels

    def _out_level(self, coords, budget):
        """``conv_out``'s sites (at most ``budget``) and taps into level 4's
        ``coords``."""
        g = self.grids
        x4, y4, _ = g[3]
        out = downsample_coords(coords, budget, stride=(2, 1, 1),
                                out_grid=(self.Zo, y4, x4), dilate=self.dilate,
                                kernel=(3, 1, 1),
                                padding=(0, 0, 0) if self.zo_ref else (1, 0, 0))
        down = build_neighbor_table(coords, g[3], query_coords=out, stride=(2, 1, 1),
                                    kernel=(3, 1, 1),
                                    padding=(0, 0, 0) if self.zo_ref else None)
        return dict(coords=out, down=down)

    def _blocks(self, lvl, feats, level):
        for name in self.level_blocks[lvl]:
            feats = getattr(self, name)(feats, level["subm"], level["valid"])
        return feats

    def encode(self, voxel_features, levels):
        """The ladder over ``geometry``'s ``levels``: the (B, n, C) features of
        levels 1-4, padding rows zero."""
        valid = levels[0]["valid"]
        feats = [self._blocks(0, torch.where(valid[..., None], voxel_features, 0.0),
                              levels[0])]
        for lvl in (1, 2, 3):
            level = levels[lvl]
            name = f"conv{lvl + 1}_down"
            h = gather_matmul_conv(feats[-1], level["down"], getattr(self, f"{name}_kernel"))
            h = torch.relu(getattr(self, f"{name}_bn")(h, level["valid"]))
            feats.append(self._blocks(lvl, h, level))
        return feats

    def encoded_bev(self, feats, out):
        """``conv_out`` over level 4's features onto its sites ``out``
        (``geometry``'s fifth level), scattered into the BEV map."""
        h = gather_matmul_conv(feats, out["down"], self.conv_out_kernel)
        h = torch.relu(self.conv_out_bn(h, out["valid"]))  # padding rows zero
        return self._scatter(h, out["coords"], out["valid"])

    def forward(self, voxel_features, voxel_coords):
        """(B, V, C) voxel features and (B, V, 3) zyx coordinates ->
        ``(bev, multi_scale)``: the BEV map (B, Y/8, X/8, Zo * C_out) and,
        per level ``x_conv1`` ... ``x_conv4``, its sparse
        ``(coords, feats, valid)``."""
        levels = self.geometry(voxel_coords)
        feats = self.encode(voxel_features, levels)
        multi_scale = {f"x_conv{i + 1}": (levels[i]["coords"], f, levels[i]["valid"])
                       for i, f in enumerate(feats)}
        return self.encoded_bev(feats[3], levels[4]), multi_scale

    def _scatter(self, h, coords, valid):
        """The last level's sites onto a dense (B, Zo, Y, X, C) canvas, as
        (B, Y, X, Zo * C): one ``index_put`` over the flat canvas, padding
        rows onto one extra row that is cut off (the JAX package's
        ``mode="drop"``)."""
        B, _, C = h.shape
        x4, y4, _ = self.grids[3]
        cells = B * self.Zo * y4 * x4
        z, y, x = coords.long().unbind(-1)
        batch = torch.arange(B, device=coords.device)[:, None]
        flat = torch.where(valid, ((batch * self.Zo + z) * y4 + y) * x4 + x, cells)
        canvas = h.new_zeros((cells + 1, C)).index_put((flat.reshape(-1),), h.reshape(-1, C))
        canvas = canvas[:cells].view(B, self.Zo, y4, x4, C)
        return canvas.permute(0, 2, 3, 1, 4).reshape(B, y4, x4, self.Zo * C)


class SparseVoxelBackBone8x(_SparseBackbone8x):
    """conv_input and conv1 (subm 16), conv2-conv4 (a strided down, then
    two subm blocks ``conv{n}_a`` / ``conv{n}_b``), conv_out (128).
    NUM_FILTERS default [16, 16, 32, 64, 64]."""

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__(model_cfg, grid_size, [16, 16, 32, 64, 64])
        w = self.widths
        self.conv_input = SubMConvBlock(input_channels, w[0])
        self.conv1 = SubMConvBlock(w[0], w[1])
        self.level_blocks = [["conv_input", "conv1"]]
        for lvl in (1, 2, 3):
            names = [f"conv{lvl + 1}_a", f"conv{lvl + 1}_b"]
            for name in names:
                self.add_module(name, SubMConvBlock(w[lvl + 1], w[lvl + 1]))
            self.level_blocks.append(names)


class SparseVoxelResBackBone8x(_SparseBackbone8x):
    """``VoxelResBackBone8x`` (spconv_backbone.py:183-293): conv_input
    (subm), then two ``SparseResBlock``s a level (``res{n}_a`` /
    ``res{n}_b``) after each strided down, conv_out (128).  NUM_FILTERS
    default [16, 16, 32, 64, 128]."""

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__(model_cfg, grid_size, [16, 16, 32, 64, 128])
        w = self.widths
        self.conv_input = SubMConvBlock(input_channels, w[0])
        self.res1_a = SparseResBlock(w[0], w[1])
        self.res1_b = SparseResBlock(w[1], w[1])
        self.level_blocks = [["conv_input", "res1_a", "res1_b"]]
        for lvl in (1, 2, 3):
            names = [f"res{lvl + 1}_a", f"res{lvl + 1}_b"]
            for name in names:
                self.add_module(name, SparseResBlock(w[lvl + 1], w[lvl + 1]))
            self.level_blocks.append(names)
