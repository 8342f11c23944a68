"""VectorPool aggregation (PV-RCNN++): counterpart of
``pdanet_tpu/models/backbones_3d/pfe/vector_pool.py`` (the reference's
``VectorPoolAggregationModule`` / ``...MSG`` in local-interpolation mode).

Each centre owns a ``NUM_LOCAL_VOXEL`` grid of sub-voxel centres inside
its neighbour distance; each sub-voxel takes the inverse-distance
interpolation of its 3 nearest support points within range
(``ops/interpolate.three_nn`` with out-of-range taps zeroed) and their
rel-xyz; the per-cell aggregation (the reference's grouped 1x1 conv) is
one einsum with a (V, C_in, C_out) kernel, ``separate_local_aggregation``,
kept in flax's layout under flax's name (the weight bridge copies it as it
is); BatchNorm + ReLU and the post MLPs follow.  Module names are the flax
ones (``layer_0.sla_bn``, ``layer_0.post_0``, ``msg_post_bn_0`` ...).
"""

import numpy as np
import torch
from torch import nn

from ....ops.interpolate import three_nn
from ....utils.easydict import EasyDict
from ...blocks import BatchNorm, Dense


def dense_grid_offsets(max_neighbour_distance, num_voxels):
    """Sub-voxel centre offsets (V, 3) float32 (JAX :32-43,
    ``get_dense_voxels_by_center``), x-major."""
    R = float(max_neighbour_distance)
    grids = []
    for n in num_voxels:
        n = int(n)
        grids.append(np.arange(-R + R / n, R - R / n + 1e-5, 2 * R / n))
    gx, gy, gz = np.meshgrid(*grids, indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                    axis=-1).astype(np.float32)


def local_interpolate(support_xyz, support_features, grid_centers, max_dist):
    """The local interpolation (JAX :46-74): support_xyz (B, N, 3),
    support_features (B, N, C), grid_centers (B, G, 3) -> (B, G, C + 9),
    the inverse-distance interpolation of the 3 nearest support points
    within ``max_dist`` (weights renormalized over those in range) || the
    rel-xyz of all three taps (out-of-range ones too), zero where none of
    the three is in range."""
    dist2, idx = three_nn(grid_centers, support_xyz)  # (B, G, 3)
    dist = torch.sqrt(dist2.clamp(min=0.0))
    in_range = dist <= max_dist
    dist_recip = torch.where(in_range, 1.0 / (dist + 1e-8), 0.0)
    norm = dist_recip.sum(dim=-1, keepdim=True)
    weight = dist_recip / norm.clamp(min=1e-8)
    B, G = idx.shape[:2]
    rows = idx.long().reshape(B, G * 3)

    def gather(t):
        return torch.gather(t, 1, rows[..., None].expand(B, G * 3, t.shape[-1])).reshape(
            B, G, 3, t.shape[-1])

    interp = (gather(support_features) * weight[..., None]).sum(dim=2)
    local = (grid_centers[:, :, None, :] - gather(support_xyz)).reshape(B, G, 9)
    out = torch.cat([interp, local.to(interp.dtype)], dim=-1)
    empty = ~in_range.any(dim=-1)
    return torch.where(empty[..., None], 0.0, out)


class VectorPoolAggregationModule(nn.Module):
    """One radius group (JAX :77-135): the channels summed in groups down
    to ``num_reduced_channels``, the local interpolation on each centre's
    sub-voxel grid at ``max_neighbor_distance * neighbor_distance_multiplier``,
    the per-cell aggregation, ``sla_bn`` and ReLU, then ``post_<k>`` /
    ``post_bn_<k>`` Dense-BN-ReLU layers."""

    def __init__(self, input_channels, num_local_voxel=(3, 3, 3), num_reduced_channels=30,
                 num_channels_of_local_aggregation=32, post_mlps=(128,),
                 max_neighbor_distance=1.0, neighbor_distance_multiplier=2.0):
        super().__init__()
        self.num_local_voxel = tuple(int(v) for v in num_local_voxel)
        V = int(np.prod(self.num_local_voxel))
        self.red = int(num_reduced_channels)
        if int(input_channels) % self.red:
            raise ValueError(f"VectorPool: {input_channels} channels do not reduce to "
                             f"{self.red}")
        self.max_neighbor_distance = float(max_neighbor_distance)
        self.reach = self.max_neighbor_distance * float(neighbor_distance_multiplier)
        c_agg = int(num_channels_of_local_aggregation)
        self.separate_local_aggregation = nn.Parameter(torch.empty(V, self.red + 9, c_agg))
        nn.init.kaiming_normal_(self.separate_local_aggregation.data.view(V * (self.red + 9),
                                                                          c_agg).T)
        self.sla_bn = BatchNorm(V * c_agg)
        c = V * c_agg
        self.n_post = len(post_mlps)
        for k, f in enumerate(post_mlps):
            self.add_module(f"post_{k}", Dense(c, int(f), bias=False))
            self.add_module(f"post_bn_{k}", BatchNorm(int(f)))
            c = int(f)
        self.out_channels = c
        self.register_buffer("offsets", torch.from_numpy(dense_grid_offsets(
            self.max_neighbor_distance, self.num_local_voxel)), persistent=False)

    def forward(self, xyz, features, new_xyz):
        """xyz (B, N, 3), features (B, N, C), new_xyz (B, M, 3) -> (B, M,
        post_mlps[-1])."""
        B, M = new_xyz.shape[:2]
        V = self.offsets.shape[0]
        C = features.shape[-1]
        feats = features.reshape(B, -1, C // self.red, self.red).sum(dim=2)
        grid_centers = (new_xyz[:, :, None, :] + self.offsets.float()).reshape(B, M * V, 3)
        vec = local_interpolate(xyz, feats, grid_centers, self.reach).reshape(
            B, M, V, self.red + 9)
        kernel = self.separate_local_aggregation
        dt = torch.promote_types(vec.dtype, kernel.dtype)
        h = torch.einsum("bmvc,vcd->bmvd", vec.to(dt), kernel.to(dt)).reshape(B, M, -1)
        h = torch.relu(self.sla_bn(h))
        for k in range(self.n_post):
            h = torch.relu(getattr(self, f"post_bn_{k}")(getattr(self, f"post_{k}")(h)))
        return h


class VectorPoolAggregationModuleMSG(nn.Module):
    """The groups of ``NUM_GROUPS`` (``layer_<k>``, JAX :138-174), their
    outputs and the centres' xyz concatenated, then the shared
    ``msg_post_<k>`` / ``msg_post_bn_<k>`` Dense-BN-ReLU layers."""

    def __init__(self, input_channels, config):
        super().__init__()
        cfg = EasyDict(config)
        self.n_groups = int(cfg.NUM_GROUPS)
        c = 3
        for k in range(self.n_groups):
            g = EasyDict(cfg[f"GROUP_CFG_{k}"])
            layer = VectorPoolAggregationModule(
                input_channels, num_local_voxel=g.NUM_LOCAL_VOXEL, post_mlps=g.POST_MLPS,
                max_neighbor_distance=g.MAX_NEIGHBOR_DISTANCE,
                num_reduced_channels=cfg.get("NUM_REDUCED_CHANNELS", input_channels),
                num_channels_of_local_aggregation=cfg.NUM_CHANNELS_OF_LOCAL_AGGREGATION)
            self.add_module(f"layer_{k}", layer)
            c += layer.out_channels
        self.n_post = len(cfg.MSG_POST_MLPS)
        for k, f in enumerate(cfg.MSG_POST_MLPS):
            self.add_module(f"msg_post_{k}", Dense(c, int(f), bias=False))
            self.add_module(f"msg_post_bn_{k}", BatchNorm(int(f)))
            c = int(f)
        self.out_channels = c

    def forward(self, xyz, features, new_xyz):
        h = torch.cat([getattr(self, f"layer_{k}")(xyz, features, new_xyz)
                       for k in range(self.n_groups)] + [new_xyz.to(features.dtype)], dim=-1)
        for k in range(self.n_post):
            h = torch.relu(getattr(self, f"msg_post_bn_{k}")(getattr(self, f"msg_post_{k}")(h)))
        return h
