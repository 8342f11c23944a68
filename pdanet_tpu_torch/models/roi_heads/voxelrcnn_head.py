"""Voxel-RCNN's RoI head: counterpart of
``pdanet_tpu/models/roi_heads/voxelrcnn_head.py:31-314``
(``pcdet/models/roi_heads/voxelrcnn_head.py`` and
``pointnet2_stack/voxel_pool_modules.NeighborVoxelSAModuleMSG``).

Each RoI's ``GRID_SIZE``^3 grid points (``get_dense_grid_points``) query
the active voxels of each sparse backbone level around them
(``SparseNeighborGridPool``): the voxel query of the reference's CUDA code
(voxel_query_gpu.cu:11-89) through the sparse engine's neighbour table
(``ops/sparse_conv.build_neighbor_table`` with a (2q+1)^3 window, q the
``QUERY_RANGES``), then the three-MLP aggregation: the features' pre-MLP,
the position MLP added, ReLU, a max over the samples, the out-MLP.  The
pooled grid of every RoI goes through the shared, cls and reg FC stacks
(``VoxelRCNNHeadNet``).

Module and parameter names are the flax ones (``pool_x_conv2.mlp_in``,
``shared_fc0``, ``shared_bn0``, ``cls_pred`` ...), so the weight bridge
maps a JAX tree onto the state dict.  Over a dense backbone
(``VoxelBackBone8x``) each level is a (B, Z, Y, X, C) grid and the pool is
the JAX package's fixed-window ``NeighborGridPool``.
"""

import math

import numpy as np
import torch
from torch import nn

from ...ops.geometry import rotate_points_along_z
from ...ops.sparse_conv import _kernel_offsets, build_neighbor_table, stage_grids
from ...utils.easydict import EasyDict
from ..blocks import BatchNorm, Dense
from .roi_head_template import dropout

# a query cell is clamped into +-2^20 before its int32 cast: far outside
# every grid, so nothing it finds changes, and the cast of a far or
# non-finite coordinate is then defined on every device
_CELL_LIMIT = float(1 << 20)


def get_dense_grid_points(rois, grid_size):
    """The RoI-local regular grid, in the lidar frame
    (voxelrcnn_head.py:193-215): rois (..., 7) -> (..., grid_size^3, 3),
    x-major (the points of one x first)."""
    g = int(grid_size)
    lead = rois.shape[:-1]
    flat = rois.reshape(-1, rois.shape[-1])
    # the cell fractions (i + 0.5) / g in float32 as XLA compiles the JAX
    # package's quotient by the constant g: a product with its float32
    # reciprocal (an ulp off the true quotient for g = 3 and 6), made on the
    # host so that every device takes the same values
    frac = torch.from_numpy((np.arange(g, dtype=np.float32) + np.float32(0.5))
                            * np.float32(1.0 / g))
    fx, fy, fz = torch.meshgrid(frac, frac, frac, indexing="ij")
    dense_frac = torch.stack([fx, fy, fz], dim=-1).reshape(-1, 3).to(rois.device)  # (g^3, 3)
    local_size = flat[:, None, 3:6]
    local = dense_frac[None] * local_size - local_size / 2
    out = rotate_points_along_z(local, flat[:, 6]) + flat[:, None, 0:3]
    return out.reshape(lead + (g * g * g, 3))


class NeighborGridPool(nn.Module):
    """The JAX package's pool over a dense level (JAX :58-119), Voxel-RCNN's
    over the dense ``VoxelBackBone8x``: a fixed 3 x 3 x 3 window of cells
    around each grid point's own cell, x-major (the offsets of one x
    first); a neighbour out of the grid or with its centre at distance >=
    ``radius`` adds nothing (an empty window pools zeros).  A dense level
    has no active set, so the sparse pool's first-K-active order does not
    apply.

    ``bn_in`` normalizes every cell of the level, ``bn_pos`` every (grid
    point, neighbour), masked ones included, as the JAX package does; the
    max over the window sends its gradient to the first maximum
    (``max_first``, ``Tensor.max(dim)``).  The cell of a grid point is
    ``floor((x - origin) * (1 / (voxel * stride)))`` and the neighbours'
    centres ``(n + 0.5) * vs + origin`` rounded once, as the JAX package's
    jitted XLA computes them (a product with the folded reciprocal; a
    fused multiply-add)."""

    def __init__(self, mlp, radius):
        super().__init__()
        c_in, c_mid, c_out = (int(c) for c in mlp)
        self.radius = float(radius)
        self.mlp_in = Dense(c_in, c_mid, bias=False)
        self.bn_in = BatchNorm(c_mid)
        self.mlp_pos = Dense(3, c_mid, bias=False)
        self.bn_pos = BatchNorm(c_mid)
        self.mlp_out = Dense(c_mid, c_out, bias=False)
        self.bn_out = BatchNorm(c_out)

    def forward(self, dense, stride, query_xyz, voxel_size, pc_range, grid_size=None):
        """dense: the level's (B, Z, Y, X, C_in) grid; query_xyz (B, G, 3)
        lidar-frame grid points -> (B, G, C_out)."""
        B, Z, Y, X, _ = dense.shape
        dev = dense.device
        f = self.bn_in(self.mlp_in(dense))
        f = f.reshape(B, Z * Y * X, f.shape[-1])
        vs = torch.tensor(voxel_size, dtype=torch.float32) * float(stride)
        dt = query_xyz.dtype
        inv = torch.reciprocal(vs.to(dt)).to(dev)
        origin = torch.tensor(pc_range[:3], dtype=torch.float32)
        cellf = torch.floor((query_xyz - origin.to(dev, dt)) * inv)
        cell = cellf.clamp(-_CELL_LIMIT, _CELL_LIMIT).to(torch.int64)
        r = torch.arange(-1, 2, device=dev)
        offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
        nb = cell[:, :, None, :] + offs  # (B, G, 27, 3) xyz
        size = torch.tensor([X, Y, Z], device=dev)
        inb = ((nb >= 0) & (nb < size)).all(dim=-1)
        nbc = torch.minimum(nb.clamp(min=0), size - 1)
        flat = (nbc[..., 2] * Y + nbc[..., 1]) * X + nbc[..., 0]  # (B, G, 27)
        G = flat.shape[1]
        gathered = torch.gather(f, 1, flat.reshape(B, G * 27, 1).expand(-1, -1, f.shape[-1]))
        gathered = gathered.reshape(B, G, 27, -1)
        centers = ((nb.double() + 0.5) * vs.double().to(dev) + origin.double().to(dev)).float()
        rel = centers.to(dt) - query_xyz[:, :, None, :]
        valid = inb & ((rel * rel).sum(dim=-1) < self.radius ** 2)
        h = torch.relu(gathered + self.bn_pos(self.mlp_pos(rel)))
        h = torch.where(valid[..., None], h, 0.0).max(dim=2).values
        return torch.relu(self.bn_out(self.mlp_out(h)))


class SparseNeighborGridPool(nn.Module):
    """Voxel-query aggregation over one sparse level (voxel_pool_modules.py:
    90-127, JAX :122-242):

    * each grid point scans the +-``query_range`` cell window around its
      own cell of the level in z-major (dz, dy, dx) order, the neighbour
      table's tap order;
    * it keeps the FIRST ``nsample`` active voxels whose centre lies within
      ``radius`` (dist^2 <= r^2), picked by ``topk`` of the tap index
      (smallest first; the taps that are not hits, which may tie, are
      masked);
    * an empty window gives the reference's "ghost": slot 0 takes part
      with zero features and a zero offset, so ``relu(bn_pos(mlp_pos(0)))``
      survives the max.

    ``bn_in`` normalizes every sparse row, padding included (the mask comes
    after it), and ``bn_pos`` every (grid point, slot), masked slots
    included, as the JAX package does.  The max over the samples sends its
    gradient to the first maximum (``Tensor.max(dim)``)."""

    def __init__(self, mlp, radius, query_range=(1, 1, 1), nsample=16):
        super().__init__()
        c_in, c_mid, c_out = (int(c) for c in mlp)
        self.radius = float(radius)
        self.kernel = tuple(2 * int(r) + 1 for r in query_range)
        self.nsample = int(nsample)
        self.mlp_in = Dense(c_in, c_mid, bias=False)
        self.bn_in = BatchNorm(c_mid)
        self.mlp_pos = Dense(3, c_mid, bias=False)
        self.bn_pos = BatchNorm(c_mid)
        self.mlp_out = Dense(c_mid, c_out, bias=False)
        self.bn_out = BatchNorm(c_out)

    def query(self, coords, stride, query_xyz, voxel_size, pc_range, grid_size):
        """The voxel query alone: ``(table, pos_idx, valid_k, empty, rel)``,
        the level's (B, G, K) neighbour table, the first-``nsample`` tap
        indices (B, G, ns), which of them are hits, the grid points whose
        window is empty (B, G) and the hits' offsets from their grid point
        (B, G, ns, 3), zero where not a hit."""
        dev = coords.device
        K = math.prod(self.kernel)
        vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * float(stride)
        origin = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
        cellf = torch.floor((query_xyz - origin) / vs).clamp(-_CELL_LIMIT, _CELL_LIMIT)
        cell_zyx = cellf.to(torch.int32).flip(-1)
        grids, _ = stage_grids(grid_size)
        lvl = grids[int(stride).bit_length() - 1]
        table = build_neighbor_table(coords, lvl, kernel=self.kernel, query_coords=cell_zyx)
        # the neighbours' centres from the window offsets, in the table's tap
        # order, float32 as the JAX package computes them: its XLA contracts
        # (n + 0.5) * vs + origin into one fused multiply-add, rounded once;
        # so is this (exact product and sum in float64, then rounded), on
        # every device, so that a centre an ulp from the radius falls alike
        offs = _kernel_offsets(self.kernel, None, dev)  # (K, 3) zyx
        nb_xyz = (cell_zyx[:, :, None, :] + offs).flip(-1)
        centers = ((nb_xyz.to(torch.float64) + 0.5) * vs.double() + origin.double()).float()
        rel_all = centers - query_xyz[:, :, None, :]  # (B, G, K, 3)
        hit = (table >= 0) & ((rel_all * rel_all).sum(dim=-1) <= self.radius ** 2)
        key = torch.where(hit, torch.arange(K, device=dev, dtype=torch.int32), K)
        key, pos_idx = torch.topk(key, self.nsample, dim=-1, largest=False)
        valid_k = key < K
        empty = ~hit.any(dim=-1)
        rel = torch.gather(rel_all, 2, pos_idx[..., None].expand(pos_idx.shape + (3,)))
        rel = torch.where(valid_k[..., None], rel, 0.0)
        return table, pos_idx, valid_k, empty, rel

    def forward(self, entry, stride, query_xyz, voxel_size, pc_range, grid_size):
        """entry: the level's sparse ``(coords (B, V, 3) zyx, feats (B, V,
        C), valid (B, V))``; query_xyz (B, G, 3) lidar-frame grid points;
        grid_size the base (nx, ny, nz) -> (B, G, C_out)."""
        coords, feats, valid = entry
        f = self.bn_in(self.mlp_in(feats))
        f = torch.where(valid[..., None], f, 0.0)
        table, pos_idx, valid_k, empty, rel = self.query(coords, stride, query_xyz, voxel_size,
                                                         pc_range, grid_size)
        B, V, C = f.shape
        slot = torch.gather(table, 2, pos_idx).clamp(min=0).long()  # (B, G, ns)
        rows = (slot + (torch.arange(B, device=slot.device) * V)[:, None, None]).reshape(-1)
        gathered = torch.index_select(f.reshape(B * V, C), 0, rows).reshape(slot.shape + (C,))
        gathered = torch.where(valid_k[..., None], gathered, 0.0)
        # the reference's empty group: slot 0 with zero features and offset
        first = torch.arange(self.nsample, device=slot.device) == 0
        valid_k = valid_k | (empty[..., None] & first)
        h = torch.relu(gathered + self.bn_pos(self.mlp_pos(rel)))
        h = torch.where(valid_k[..., None], h, 0.0).max(dim=2).values
        return torch.relu(self.bn_out(self.mlp_out(h)))


class VoxelRCNNHeadNet(nn.Module):
    """The multi-scale RoI grid pool and the refinement FC stacks
    (voxelrcnn_head.py:105-260; JAX :245-314).  ``level_channels`` maps each
    of ``ROI_GRID_POOL.FEATURES_SOURCE`` to its sparse level's channels,
    ``strides`` to its stride.  The three stacks are Dense (no bias),
    BatchNorm over every RoI of the batch and ReLU, with dropout of
    ``DP_RATIO`` between layers in all three (:49-50, 62-63, 76-77):
    flax's keep-and-scale form, its keep masks given by the caller
    (:meth:`dropout_shapes`)."""

    def __init__(self, model_cfg, code_size, num_class, level_channels, strides, grid_size,
                 voxel_size, point_cloud_range, dense=False):
        super().__init__()
        cfg = EasyDict(model_cfg)
        pool_cfg = cfg.ROI_GRID_POOL
        self.grid = int(pool_cfg.GRID_SIZE)
        self.sources = list(pool_cfg.FEATURES_SOURCE)
        self.strides = {src: int(strides[src]) for src in self.sources}
        self.geometry = (tuple(grid_size), tuple(voxel_size), tuple(point_cloud_range))
        c_pool = 0
        for src in self.sources:
            lcfg = EasyDict(pool_cfg.POOL_LAYERS[src])
            mlp = [int(level_channels[src])] + [int(c) for c in lcfg.MLPS[0]]
            if dense:
                pool = NeighborGridPool(mlp, lcfg.POOL_RADIUS[0])
            else:
                pool = SparseNeighborGridPool(mlp, lcfg.POOL_RADIUS[0],
                                              lcfg.get("QUERY_RANGES", [[1, 1, 1]])[0],
                                              lcfg.get("NSAMPLE", [16])[0])
            self.add_module(f"pool_{src}", pool)
            c_pool += mlp[-1]
        self.dp = float(cfg.get("DP_RATIO", 0.0))
        self.stacks = {"shared": list(cfg.SHARED_FC), "cls": list(cfg.CLS_FC),
                       "reg": list(cfg.REG_FC)}
        c_in = {"shared": self.grid ** 3 * c_pool}
        c_in["cls"] = c_in["reg"] = self.stacks["shared"][-1]
        for prefix, widths in self.stacks.items():
            c = c_in[prefix]
            for k, f in enumerate(widths):
                self.add_module(f"{prefix}_fc{k}", Dense(c, f, bias=False))
                self.add_module(f"{prefix}_bn{k}", BatchNorm(f))
                c = f
        self.cls_pred = Dense(self.stacks["cls"][-1], num_class)
        self.reg_pred = Dense(self.stacks["reg"][-1], code_size * num_class)
        with torch.no_grad():  # flax's normal(0.01) / normal(0.001), zero bias
            for layer, std in ((self.cls_pred, 0.01), (self.reg_pred, 0.001)):
                layer.weight.normal_(0.0, std)
                layer.bias.zero_()

    def dropout_shapes(self, rois_per_frame):
        """``{name: (R, C)}``: the keep mask a frame that each dropout of
        the stacks takes, ``<prefix><k>`` after layer k; none without
        ``DP_RATIO``."""
        if self.dp <= 0:
            return {}
        return {f"{prefix}{k}": (rois_per_frame, f) for prefix, widths in self.stacks.items()
                for k, f in enumerate(widths[:-1])}

    def _stack(self, x, prefix, keep):
        widths = self.stacks[prefix]
        for k in range(len(widths)):
            x = torch.relu(getattr(self, f"{prefix}_bn{k}")(getattr(self, f"{prefix}_fc{k}")(x)))
            if k != len(widths) - 1 and self.training and self.dp > 0:
                x = dropout(x, keep, f"{prefix}{k}", self.dp)
        return x

    def pool(self, multi_scale, grid_xyz):
        """Every level's voxel-query pool of the (B, G, 3) grid points, one
        level's table and pool at a time -> (B, G, C) pooled features."""
        grid_size, voxel_size, pc_range = self.geometry
        return torch.cat([
            getattr(self, f"pool_{src}")(multi_scale[src], self.strides[src], grid_xyz,
                                         voxel_size, pc_range, grid_size)
            for src in self.sources], dim=-1)

    def refine(self, pooled, keep=None):
        """The FC stacks on the (B, R, g^3 * C) pooled grid of each RoI ->
        ``(rcnn_cls, rcnn_reg)``."""
        if self.training and self.dp > 0 and keep is None:
            raise ValueError("VoxelRCNNHeadNet: training with DP_RATIO takes the dropout "
                             "keep masks (train.make_train_step draws them)")
        shared = self._stack(pooled, "shared", keep)
        return (self.cls_pred(self._stack(shared, "cls", keep)),
                self.reg_pred(self._stack(shared, "reg", keep)))

    def forward(self, multi_scale, rois, keep=None):
        """multi_scale: ``{level: (coords, feats, valid)}`` of a sparse
        backbone or ``{level: (B, Z, Y, X, C)}`` of a dense one; rois (B,
        R, 7); ``keep``: in training with ``DP_RATIO``,
        ``{name: (B, R, C) bool}`` (:meth:`dropout_shapes`) -> ``rcnn_cls``
        (B, R, num_class), ``rcnn_reg`` (B, R, code_size * num_class)."""
        B, R = rois.shape[:2]
        grid_xyz = get_dense_grid_points(rois, self.grid).reshape(B, R * self.grid ** 3, 3)
        return self.refine(self.pool(multi_scale, grid_xyz).reshape(B, R, -1), keep)
