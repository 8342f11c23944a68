"""Dense voxel backbones: counterpart of ``pdanet_tpu/models/backbones_3d/
voxel_backbone.py`` (``spconv_backbone.VoxelBackBone8x`` and
``VoxelResBackBone8x`` of the reference on a dense grid).

The (B, V, C) voxel features are scattered once into a dense grid with
the reference's empty top z plane (``sparse_shape = grid_size[::-1] +
[1, 0, 0]``), and the ladder runs as ordinary 3-D convolutions (cuDNN):
conv_input and conv1 (stride 1), three strided downs (conv4 with z
padding 0) each followed by two stride-1 blocks, and the z-compressing
``conv_out`` ((3, 1, 1), stride (2, 1, 1), ``last_pad`` 0), so that the
KITTI z chain is 41 -> 21 -> 11 -> 5 -> 2.  Paddings are torch's
symmetric ones, as the JAX package gives them explicitly.

Submanifold masking (``SUBMANIFOLD_MASKING``, on by default): every
level's active cells are spconv's (a k3/s2 max-pool of the level below,
``occupancy_levels``), each BatchNorm takes its statistics over the
active cells alone and every block zeroes the inactive cells, so that the
dense values equal the sparse engine's at the active sites.  The masked
BatchNorm and ReLU of a block is one autograd function
(:class:`_MaskedBNReLU`) that keeps only the active cells' values for its
backward and writes its output over the convolution's, so that training
at the 0.05 m KITTI grid (41 x 1600 x 1408 cells, 5.9 GB a 16-channel
float32 level) holds few full-grid tensors.

Layout: the grid is (B, C, Z, Y, X), in ``memory_format`` (NCDHW, or
``torch.channels_last_3d``); the height compression is the JAX package's
transpose, BEV channel = z * C + c; ``multi_scale`` holds every level as a
(B, Z, Y, X, C) view, as the JAX package returns it.  Parameter names are
the flax ones: ``conv_input.Conv_0`` (a :class:`blocks.Conv3d`), its
``BatchNorm_0``; a residual block's ``conv1`` / ``bn1`` / ``conv2`` /
``bn2``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ... import parallel
from ...ops.sparse_conv import stage_grids
from ...utils.easydict import EasyDict
from ..blocks import BatchNorm, Conv3d


def _cells(x):
    """(B, C, Z, Y, X) -> a (B, S, C) view of its cells, in either memory
    format."""
    return x.permute(0, 2, 3, 4, 1).flatten(1, 3)


def gather_cells(x, rows):
    """The (n, C) values of ``x`` at ``rows`` (a flat cell index tensor a
    frame), frame after frame."""
    cells = _cells(x)
    return torch.cat([cells[b].index_select(0, r) for b, r in enumerate(rows)])


def scatter_cells(out, rows, vals):
    """Write ``vals`` (n, C) into ``out`` at ``rows``, frame by frame (each
    frame's index stays below 2^31 cells x channels)."""
    cells = _cells(out)
    start = 0
    for b, r in enumerate(rows):
        cells[b].index_copy_(0, r, vals[start:start + len(r)])
        start += len(r)
    return out


def _flat_cells(voxel_coords, grid_zyx):
    """(B, V, 3) zyx coordinates -> (flat cell index a frame, valid); a
    padding row's index is 0."""
    Z, Y, X = grid_zyx
    coords = voxel_coords.long()
    valid = (coords >= 0).all(dim=-1)
    flat = (coords[..., 0] * Y + coords[..., 1]) * X + coords[..., 2]
    return torch.where(valid, flat, 0), valid


def scatter_to_dense(voxel_features, voxel_coords, grid_size, z_pad=1,
                     memory_format=torch.contiguous_format):
    """(B, V, C) features and (B, V, 3) zyx coordinates (-1 pads) -> the
    dense (B, C, Z + z_pad, Y, X) grid (JAX :36-53).  A padding row adds
    zeros to cell 0, which drops it as ``.at[].set(mode="drop")`` does; the
    voxelizer's cells are distinct, so each cell takes one value and no
    write order matters.  No shape depends on the data (``torch.export``)."""
    B, V, C = voxel_features.shape
    nx, ny, nz = (int(g) for g in grid_size)
    nz += int(z_pad)
    canvas = torch.empty((B, C, nz, ny, nx), dtype=voxel_features.dtype,
                         device=voxel_features.device, memory_format=memory_format).zero_()
    flat, valid = _flat_cells(voxel_coords, (nz, ny, nx))
    feats = torch.where(valid[..., None], voxel_features, 0.0)
    cells = _cells(canvas)
    for b in range(B):
        cells[b].index_put_((flat[b],), feats[b], accumulate=True)
    return canvas


def pad_top_z(x):
    """Append the reference's empty top z plane to a pre-scattered
    (B, C, Z, Y, X) grid (JAX :56-59)."""
    return F.pad(x, (0, 0, 0, 0, 0, 1))


def down_z_pad(z):
    """The z padding of conv4 and conv_out (JAX :62-68): the reference's 0,
    or 1 where a tiny grid would lose its last z plane."""
    return (0, 0) if int(z) >= 3 else (1, 1)


def occupancy_levels(occ0):
    """The active cells of the four levels and conv_out from the stride-1
    occupancy (B, Z0, Y0, X0) bool (JAX :71-96): a downsampled site is
    active iff its tap window holds an active cell, a k3/s2 max-pool with
    the stage's padding (``F.max_pool3d`` pads with -inf)."""
    occs = [occ0]
    cur = occ0[:, None].to(torch.float32)
    for lvl in (1, 2, 3):
        zp = 1 if lvl < 3 else down_z_pad(cur.shape[2])[0]
        cur = F.max_pool3d(cur, 3, stride=2, padding=(zp, 1, 1))
        occs.append(cur[:, 0] > 0)
    out = F.max_pool3d(cur, (3, 1, 1), stride=(2, 1, 1),
                       padding=(down_z_pad(cur.shape[2])[0], 0, 0))
    occs.append(out[:, 0] > 0)
    return occs


def grid_occupancies(grid, voxel_coords, model_cfg):
    """Every level's active cells (JAX :99-113), from the voxel coordinates
    on the (B, C, Z, Y, X) ``grid``, or, for a dynamic VFE's pre-scattered
    grid (``voxel_coords`` None), its cells with a nonzero channel
    (``SUBMANIFOLD_MASKING`` on); ``[None] * 5`` (off)."""
    if not bool(EasyDict(model_cfg or {}).get("SUBMANIFOLD_MASKING", True)):
        return [None] * 5
    B, _, Z, Y, X = grid.shape
    if voxel_coords is None:
        occ0 = (grid != 0).any(dim=1)
    else:
        flat, valid = _flat_cells(voxel_coords, (Z, Y, X))
        hits = torch.zeros((B, Z * Y * X), dtype=torch.float32, device=grid.device)
        hits.scatter_add_(1, flat, valid.to(torch.float32))
        occ0 = (hits > 0).view(B, Z, Y, X)
    return [Occupancy(o) for o in occupancy_levels(occ0)]


class Occupancy:
    """One level's active cells: the (B, Z, Y, X) mask, its (B, 1, Z, Y, X)
    float copy that zeroes the inactive cells, and, made at first use (a
    training forward), the flat indices of the active cells a frame."""

    def __init__(self, mask):
        self.mask = mask
        self.factor = mask[:, None].to(torch.float32)
        self._rows = None

    @property
    def rows(self):
        if self._rows is None:
            flat = self.mask.flatten(1)
            self._rows = [torch.nonzero(flat[b])[:, 0] for b in range(flat.shape[0])]
        return self._rows


class _MaskedBNReLU(torch.autograd.Function):
    """Training-mode masked BatchNorm (+ ReLU) of a dense level, over the
    convolution's output ``x``, which it overwrites (``mark_dirty``): the
    statistics of the active cells (global ones in a process group), the
    running statistics moved, the output zero but at the active cells.
    Its backward reads the saved active values alone: the gradient of x is
    zero at the inactive cells, which feed neither the output nor the
    statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn, rows, relu):
        ct = torch.promote_types(x.dtype, weight.dtype)
        vals = gather_cells(x, rows).to(ct)
        n_local = vals.new_full((1,), float(vals.shape[0]))
        total = parallel.all_reduce_detached(torch.cat([vals.sum(dim=0), n_local]))
        n = total[-1].clamp(min=1.0)
        mean = total[:-1] / n
        centred = vals - mean
        var = parallel.all_reduce_detached((centred * centred).sum(dim=0)) / n
        unbiased = var * (n / (n - 1.0).clamp(min=1.0))
        m = bn.momentum
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * unbiased)
        rstd = torch.rsqrt(var + bn.eps)
        xhat = centred * rstd
        y = xhat * weight + bias
        if relu:
            y = torch.relu(y)
        ctx.mark_dirty(x)
        x.zero_()
        scatter_cells(x, rows, y.to(x.dtype))
        ctx.rows, ctx.n = rows, n
        ctx.save_for_backward(xhat, rstd, weight, (y > 0) if relu else None)
        return x

    @staticmethod
    def backward(ctx, grad):
        xhat, rstd, weight, pos = ctx.saved_tensors
        dy = gather_cells(grad, ctx.rows).to(xhat.dtype)
        if pos is not None:
            dy = torch.where(pos, dy, 0.0)
        d_bias, d_weight = dy.sum(dim=0), (dy * xhat).sum(dim=0)
        total = parallel.all_reduce_detached(torch.cat([d_bias, d_weight]))
        s1, s2 = total.split(d_bias.shape[0])
        dx = (weight * rstd) * (dy - s1 / ctx.n - xhat * (s2 / ctx.n))
        d_x = scatter_cells(torch.zeros_like(grad), ctx.rows, dx.to(grad.dtype))
        return d_x, d_weight.to(weight.dtype), d_bias.to(weight.dtype), None, None, None


class DenseMaskedBatchNorm(BatchNorm):
    """BatchNorm over the active cells of a dense (B, C, Z, Y, X) level,
    the inactive cells zeroed (JAX :116-149; spconv's BatchNorm1d runs on
    the active-site list), with an optional ReLU after it; momentum 0.99
    and eps 1e-3 (flax's), the running variance the unbiased one over the
    active-cell count.  Without an occupancy (``SUBMANIFOLD_MASKING``
    off) it is the plain BatchNorm over every cell.

    At eval the affine, the ReLU and the mask run in place on the
    convolution's output unless a gradient is wanted."""

    def __init__(self, channels, momentum=0.99):
        super().__init__(channels, eps=1e-3, momentum=momentum)

    def forward(self, x, occ, relu=True):
        if occ is None:
            y = super().forward(x.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
            return torch.relu(y) if relu else y
        if self.training:
            return _MaskedBNReLU.apply(x, self.weight, self.bias, self, occ.rows, relu)
        ct = torch.promote_types(x.dtype, self.weight.dtype)
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * scale
        shape = (1, -1, 1, 1, 1)
        scale, shift = scale.to(ct).view(shape), shift.to(ct).view(shape)
        factor = occ.factor.to(ct)
        if torch.is_grad_enabled() and x.requires_grad:
            y = x.to(ct) * scale + shift
            return (torch.relu(y) if relu else y) * factor
        x = x.to(ct).mul_(scale).add_(shift)
        return (x.relu_() if relu else x).mul_(factor)


class Conv3DBNReLU(nn.Module):
    """Conv3d (no bias) -> the masked BatchNorm -> ReLU (JAX :152-184);
    ``padding`` per axis (zyx), torch's symmetric k // 2 by default."""

    def __init__(self, c_in, features, kernel=(3, 3, 3), stride=(1, 1, 1), padding=None,
                 bn_momentum=0.99):
        super().__init__()
        if padding is None:
            padding = tuple(int(k) // 2 for k in kernel)
        self.Conv_0 = Conv3d(c_in, features, kernel, stride=stride, padding=padding,
                             bias=False)
        self.BatchNorm_0 = DenseMaskedBatchNorm(features, momentum=bn_momentum)

    def forward(self, x, occ):
        return self.BatchNorm_0(self.Conv_0(x), occ)


def _z_chain(grid_size):
    """The z extent of every level and conv_out, and the z paddings of
    conv4 and conv_out (``down_z_pad``), from the (nx, ny, nz) grid."""
    grids, _ = stage_grids(grid_size)
    z = [g[2] for g in grids[:3]]
    pad4 = down_z_pad(z[2])[0]
    z.append((z[2] + 2 * pad4 - 3) // 2 + 1)
    pad_out = down_z_pad(z[3])[0]
    z.append((z[3] + 2 * pad_out - 3) // 2 + 1)
    return z, pad4, pad_out


class _DenseBackbone8x(nn.Module):
    """What both dense backbones share: the scatter, the occupancies, the
    z chain and the height compression.  ``memory_format`` is the grid's
    (NCDHW by default)."""

    def __init__(self, model_cfg, grid_size):
        super().__init__()
        self.cfg = EasyDict(model_cfg or {})
        self.grid_size = tuple(int(g) for g in grid_size)
        self.bn_momentum = float(self.cfg.get("BN_MOMENTUM", 0.99))
        self.z_chain, self.pad4, self.pad_out = _z_chain(self.grid_size)
        self.memory_format = torch.contiguous_format

    def grid(self, voxel_features, voxel_coords):
        """The dense level-0 grid and every level's occupancy: the (B, V, C)
        voxel list scattered, or a dynamic VFE's (B, Z, Y, X, C) grid
        (``voxel_coords`` None) with the top z plane appended."""
        if voxel_coords is None:
            x = pad_top_z(voxel_features.permute(0, 4, 1, 2, 3)).contiguous(
                memory_format=self.memory_format)
        else:
            x = scatter_to_dense(voxel_features, voxel_coords, self.grid_size,
                                 memory_format=self.memory_format)
        return x, grid_occupancies(x, voxel_coords, self.cfg)

    @staticmethod
    def compress(x):
        """Height compression (JAX :240-242): (B, C, Z, Y, X) -> the BEV map
        (B, Y, X, Z * C), channel z * C + c."""
        B, C, Z, Y, X = x.shape
        return x.permute(0, 3, 4, 2, 1).reshape(B, Y, X, Z * C)

    @staticmethod
    def channels_last(levels):
        return {f"x_conv{i + 1}": t.permute(0, 2, 3, 4, 1) for i, t in enumerate(levels)}


class VoxelBackBone8x(_DenseBackbone8x):
    """The dense ``VoxelBackBone8x`` (JAX :187-249): conv_input and conv1,
    conv2-conv4 (a strided down, then ``_a`` / ``_b``), conv_out.
    model_cfg: NUM_FILTERS ([16, 16, 32, 64, 64]), NUM_OUTPUT_FEATURES
    (128), BN_MOMENTUM (0.99; not conv_out's, as in the JAX package),
    SUBMANIFOLD_MASKING (True)."""

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__(model_cfg, grid_size)
        w = [int(c) for c in self.cfg.get("NUM_FILTERS", [16, 16, 32, 64, 64])]
        self.widths = w  # x_conv<i> has widths[i] channels
        c_out = int(self.cfg.get("NUM_OUTPUT_FEATURES", 128))
        m = self.bn_momentum
        self.conv_input = Conv3DBNReLU(input_channels, w[0], bn_momentum=m)
        self.conv1 = Conv3DBNReLU(w[0], w[1], bn_momentum=m)
        for lvl in (2, 3, 4):
            c_in = w[lvl - 1]
            pad = (self.pad4, 1, 1) if lvl == 4 else None
            self.add_module(f"conv{lvl}_down", Conv3DBNReLU(
                c_in, w[lvl], stride=(2, 2, 2), padding=pad, bn_momentum=m))
            for suf in ("a", "b"):
                self.add_module(f"conv{lvl}_{suf}", Conv3DBNReLU(w[lvl], w[lvl], bn_momentum=m))
        self.conv_out = Conv3DBNReLU(w[4], c_out, kernel=(3, 1, 1), stride=(2, 1, 1),
                                     padding=(self.pad_out, 0, 0))
        self.num_bev_features = self.z_chain[4] * c_out

    def forward(self, voxel_features, voxel_coords):
        """(B, V, C) voxel features and (B, V, 3) zyx coordinates, or a
        dynamic VFE's (B, Z, Y, X, C) grid and None ->
        ``(bev, multi_scale)``: the (B, Y/8, X/8, Zo * C_out) BEV map and
        ``x_conv1`` ... ``x_conv4`` as (B, Z, Y, X, C) views."""
        x, occs = self.grid(voxel_features, voxel_coords)
        x = self.conv_input(x, occs[0])
        levels = [self.conv1(x, occs[0])]
        for lvl in (2, 3, 4):
            occ = occs[lvl - 1]
            x = getattr(self, f"conv{lvl}_down")(levels[-1], occ)
            x = getattr(self, f"conv{lvl}_a")(x, occ)
            levels.append(getattr(self, f"conv{lvl}_b")(x, occ))
        out = self.conv_out(levels[-1], occs[4])
        return self.compress(out), self.channels_last(levels)


class ResBlock3D(nn.Module):
    """conv-BN-ReLU-conv-BN plus the identity, ReLU after the sum (JAX
    :252-276), the BatchNorms masked."""

    def __init__(self, features, bn_momentum=0.99):
        super().__init__()
        self.conv1 = Conv3d(features, features, 3, padding=1, bias=False)
        self.bn1 = DenseMaskedBatchNorm(features, momentum=bn_momentum)
        self.conv2 = Conv3d(features, features, 3, padding=1, bias=False)
        self.bn2 = DenseMaskedBatchNorm(features, momentum=bn_momentum)

    def forward(self, x, occ):
        h = self.bn1(self.conv1(x), occ)
        h = self.bn2(self.conv2(h), occ, relu=False)
        return torch.relu(x + h)


class VoxelResBackBone8x(_DenseBackbone8x):
    """The dense ``VoxelResBackBone8x`` (JAX :279-331): conv_input (16), two
    ``ResBlock3D`` a level (``res{n}_a`` / ``_b``) after each strided down
    (32, 64, 128), conv_out (128), every BatchNorm at BN_MOMENTUM."""

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__(model_cfg, grid_size)
        m = self.bn_momentum
        self.widths = [16, 16, 32, 64, 128]  # x_conv<i> has widths[i] channels
        self.conv_input = Conv3DBNReLU(input_channels, 16, bn_momentum=m)
        for lvl, c in ((1, 16), (2, 32), (3, 64), (4, 128)):
            if lvl > 1:
                pad = (self.pad4, 1, 1) if lvl == 4 else None
                self.add_module(f"conv{lvl}_down", Conv3DBNReLU(
                    c // 2, c, stride=(2, 2, 2), padding=pad, bn_momentum=m))
            for suf in ("a", "b"):
                self.add_module(f"res{lvl}_{suf}", ResBlock3D(c, bn_momentum=m))
        self.conv_out = Conv3DBNReLU(128, 128, kernel=(3, 1, 1), stride=(2, 1, 1),
                                     padding=(self.pad_out, 0, 0), bn_momentum=m)
        self.num_bev_features = self.z_chain[4] * 128

    def forward(self, voxel_features, voxel_coords):
        x, occs = self.grid(voxel_features, voxel_coords)
        x = self.conv_input(x, occs[0])
        levels = []
        for lvl in (1, 2, 3, 4):
            occ = occs[lvl - 1]
            if lvl > 1:
                x = getattr(self, f"conv{lvl}_down")(x, occ)
            x = getattr(self, f"res{lvl}_b")(getattr(self, f"res{lvl}_a")(x, occ), occ)
            levels.append(x)
        out = self.conv_out(x, occs[4])
        return self.compress(out), self.channels_last(levels)
