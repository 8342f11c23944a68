"""Voxel set abstraction, PV-RCNN's keypoint feature extractor: counterpart
of ``pdanet_tpu/models/backbones_3d/pfe/voxel_set_abstraction.py``
(``pcdet/models/backbones_3d/pfe/voxel_set_abstraction.py`` and the
stacked SA aggregation it drives).

Everything is padded-dense ``(B, N, ...)`` with validity masks, as in the
JAX package:

* ``NUM_KEYPOINTS`` keypoints by D-FPS over the raw points (the kernel of
  ``ops/sampling.py``), or over the points that SPC keeps near a proposal
  (``spc_proximity_collapse``, PV-RCNN++);
* each feature source gives each keypoint a vector: the BEV map
  bilinearly at stride 8, the raw points and every sparse (or dense)
  backbone level through a ball-query aggregation (``MaskedSAModuleMSG``,
  the kernel of ``ops/ball_query.py``) or VectorPool
  (``vector_pool.py``);
* a level's voxels are its active sites (``sparse_to_voxel_list``, the
  shipped yamls' sparse backbone) or the first ``MAX_VOXELS`` active cells
  of a dense grid in scan order (``dense_to_voxel_list``); an invalid row's
  centre is ``FAR_SENTINEL``, out of every query ball;
* the sources' vectors are concatenated (the BEV map's first, then the raw
  points', then the levels' in ``FEATURES_SOURCE`` order) and fused by a
  Dense + BatchNorm + ReLU.

The kernels compute in float32, a float64 model's coordinates rounded;
the plain ball query of the CPU computes in the model's dtype, as the JAX
package does (a float64 run on the card against the CPU feeds the card's
indices to the CPU).  Module names are the flax ones (``SA_rawpoints``,
``SA_x_conv1.mlps_0.layer0.dense``, ``fusion``, ``fusion_bn``), so the
weight bridge maps a JAX tree onto the state dict.
"""

import torch
from torch import nn

from ....ops.ball_query import ball_query_multi
from ....ops.grouping import gather_points, group_points
from ....ops.sampling import farthest_point_sample
from ....utils.easydict import EasyDict
from ...blocks import BatchNorm, Dense, MLPStack
from ...model_utils.centernet_utils import div_const

FAR_SENTINEL = 1.0e6


def bilinear_interpolate(im, x, y):
    """``bilinear_interpolate_torch`` (JAX :41-68): clamped-index bilinear
    taps (no zero padding, unlike ``grid_sample``).  im (H, W, C), x / y
    (M,) fractional index coordinates -> (M, C)."""
    H, W, _ = im.shape
    x0, y0 = torch.floor(x), torch.floor(y)

    def tap(xi, yi):
        return im[yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]

    wa = (x0 + 1 - x) * (y0 + 1 - y)
    wb = (x0 + 1 - x) * (y - y0)
    wc = (x - x0) * (y0 + 1 - y)
    wd = (x - x0) * (y - y0)
    return (tap(x0, y0) * wa[:, None] + tap(x0, y0 + 1) * wb[:, None]
            + tap(x0 + 1, y0) * wc[:, None] + tap(x0 + 1, y0 + 1) * wd[:, None])


def multi_scale_occupancy(voxel_coords, grid_size, strides):
    """The active cells of each backbone scale (JAX :71-112): voxel_coords
    (B, V, 3) zyx with -1 pads, the base grid (nx, ny, nz), sorted strides
    (1, 2, 4, 8) -> ``{stride: (B, Z_s, Y_s, X_s) bool}``.  Stride 1 is the
    input pattern on ``nz + 1`` z planes (the reference's empty top plane),
    rows out of the grid dropped; each step after it a k3 / s2 max-pool,
    its z padding 0 from stride 4 to 8 where the grid has 3 or more z
    planes, else 1 (the dense backbones' rule)."""
    B = voxel_coords.shape[0]
    nx, ny, nz = int(grid_size[0]), int(grid_size[1]), int(grid_size[2]) + 1
    z, y, x = voxel_coords.long().unbind(-1)
    inside = ((z >= 0) & (z < nz) & (y >= 0) & (y < ny) & (x >= 0) & (x < nx))
    cells = nz * ny * nx
    batch = torch.arange(B, device=voxel_coords.device)[:, None]
    flat = torch.where(inside, ((batch * nz + z) * ny + y) * nx + x, B * cells)
    occ = torch.zeros(B * cells + 1, dtype=torch.float32, device=voxel_coords.device)
    occ = occ.index_put((flat.reshape(-1),), torch.ones((), device=occ.device))
    cur = occ[:B * cells].view(B, 1, nz, ny, nx)
    out, s = {}, 1
    if 1 in strides:
        out[1] = cur[:, 0] > 0
    while s < max(strides):
        z_pad = 0 if (s == 4 and cur.shape[2] >= 3) else 1
        cur = nn.functional.max_pool3d(cur, 3, stride=2, padding=(z_pad, 1, 1))
        s *= 2
        if s in strides:
            out[s] = cur[:, 0] > 0
    return out


def voxel_centres(xyz_idx, voxel_size, stride, pc_range):
    """The float32 centres ``(idx + 0.5) * vs + origin`` of cells ``xyz_idx``
    (..., 3) x-first, vs the voxel size times ``stride``: XLA contracts the
    JAX package's product and sum into one fused multiply-add, rounded
    once; so is this (exact in float64, then rounded), on every device."""
    dev = xyz_idx.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * float(stride)
    origin = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    return ((xyz_idx.to(torch.float32) + 0.5).double() * vs.double()
            + origin.double()).float()


def sparse_to_voxel_list(entry, stride, voxel_size, pc_range):
    """A sparse level ``(coords (B, V, 3) zyx, feats, valid)`` as the voxel
    list (JAX :115-125): centres (B, V, 3) float32, ``FAR_SENTINEL`` on
    invalid rows, features zeroed there, and ``valid``."""
    coords, feats, valid = entry
    centres = voxel_centres(coords.flip(-1), voxel_size, stride, pc_range)
    centres = torch.where(valid[..., None], centres, FAR_SENTINEL)
    return centres, torch.where(valid[..., None], feats, 0.0), valid


def dense_to_voxel_list(grid, occ, max_voxels, stride, voxel_size, pc_range):
    """The first ``max_voxels`` active cells of a dense level in zyx scan
    order (JAX :128-157, ``lax.top_k`` of the 0/1 occupancy: the lowest
    indices among ties; here a stable descending sort): grid (B, Z, Y, X,
    C), occ (B, Z, Y, X) bool -> centres (B, V, 3) (``FAR_SENTINEL`` on
    invalid rows), feats (B, V, C) (zero there), valid (B, V)."""
    B, Z, Y, X, C = grid.shape
    V = int(max_voxels)
    score, idx = torch.sort(occ.reshape(B, -1).to(torch.float32), dim=-1, descending=True,
                            stable=True)
    score, idx = score[:, :V], idx[:, :V]
    valid = score > 0
    feats = torch.gather(grid.reshape(B, -1, C), 1, idx[..., None].expand(B, V, C))
    feats = torch.where(valid[..., None], feats, 0.0)
    z, y, x = idx // (Y * X), (idx // X) % Y, idx % X
    centres = voxel_centres(torch.stack([x, y, z], dim=-1), voxel_size, stride, pc_range)
    centres = torch.where(valid[..., None], centres, FAR_SENTINEL)
    return centres, feats, valid


class MaskedSAModuleMSG(nn.Module):
    """``StackSAModuleMSG`` on padded-dense batches (JAX :160-201): for each
    radius the first-K ball query around the centres, rel-xyz || features
    (the features alone without ``use_xyz``; rel-xyz alone without
    features), a Dense-BN-ReLU stack ``mlps_<i>``, the max over the group
    (its gradient to the first maximum, as ``max_first``), and a group
    whose slot 0 is out of the radius (the query pads an empty ball with
    index 0) zeroed.  ``site`` names the query for the kernel's launch
    count (``ops/ball_query.py``)."""

    def __init__(self, in_features, radii, nsamples, mlps, use_xyz=True, site=""):
        super().__init__()
        self.site = site
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(k) for k in nsamples)
        self.use_xyz = use_xyz
        c_in = in_features + 3 if (use_xyz or not in_features) else in_features
        for i, m in enumerate(mlps):
            self.add_module(f"mlps_{i}", MLPStack(c_in, [int(c) for c in m]))
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz, features, new_xyz):
        """xyz (B, N, 3) support (invalid rows at ``FAR_SENTINEL``), features
        (B, N, C) or None, new_xyz (B, M, 3) -> (B, M, sum(mlp[-1]))."""
        dt = torch.promote_types(xyz.dtype, new_xyz.dtype)
        idx_list = ball_query_multi(self.radii, self.nsamples, xyz.to(dt).contiguous(),
                                    new_xyz.to(dt).contiguous(), self.site)
        outs = []
        for i, idx in enumerate(idx_list):
            first = group_points(xyz, idx[:, :, :1])[:, :, 0, :] - new_xyz
            nonempty = (first ** 2).sum(dim=-1) < self.radii[i] ** 2
            grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
            if features is None:
                grouped = grouped_xyz
            elif self.use_xyz:
                grouped = torch.cat([grouped_xyz, group_points(features, idx)], dim=-1)
            else:
                grouped = group_points(features, idx)
            h = getattr(self, f"mlps_{i}")(grouped).max(dim=2).values
            outs.append(torch.where(nonempty[..., None], h, 0.0))
        return torch.cat(outs, dim=-1)


def make_aggregator(scfg, input_channels, site):
    """The aggregation of one source, or of the RoI grid pool (JAX
    ``_make_aggregator`` :204-220): VectorPool for
    ``VectorPoolAggregationModuleMSG``, else the masked SA, its ball query
    named ``site``."""
    if scfg.get("NAME", "StackSAModuleMSG") == "VectorPoolAggregationModuleMSG":
        from .vector_pool import VectorPoolAggregationModuleMSG

        return VectorPoolAggregationModuleMSG(input_channels, scfg)
    return MaskedSAModuleMSG(input_channels, scfg.POOL_RADIUS, scfg.NSAMPLE, scfg.MLPS,
                             site=site)


def _near_roi(xyz, rois, radius):
    """(B, N) whether each point lies within (its nearest RoI's
    half-diagonal + ``radius``) of that RoI's centre; every point of a
    frame without a valid RoI."""
    roi_valid = (rois[..., 0:7] != 0).any(dim=-1)  # (B, R)
    diff = xyz[:, :, None, :] - rois[:, None, :, 0:3]
    d = torch.sqrt((diff * diff).sum(dim=-1))  # (B, N, R)
    d = torch.where(roi_valid[:, None, :], d, torch.inf)
    d_min, nearest = d.min(dim=-1)
    dims = torch.gather(rois[..., 3:6], 1, nearest[..., None].expand(-1, -1, 3)) / 2.0
    max_dim = torch.sqrt((dims * dims).sum(dim=-1))
    keep = d_min < max_dim + radius
    return keep | ~roi_valid.any(dim=-1, keepdim=True)


def spc_proximity_collapse(xyz, rois, sample_radius_with_roi):
    """SPC's proximity filter (JAX :223-252, ``sample_points_with_roi``):
    xyz (B, N, 3), rois (B, R, 7+) -> (B, N, 3), every point farther than
    (its nearest RoI's half-diagonal + the radius) from that RoI's centre
    moved onto the first point kept, so that FPS never prefers it."""
    keep = _near_roi(xyz, rois, sample_radius_with_roi)
    anchor_idx = torch.argmax(keep.to(torch.uint8), dim=-1)  # the first kept point
    anchor = torch.gather(xyz, 1, anchor_idx[:, None, None].expand(-1, 1, 3))
    return torch.where(keep[..., None], xyz, anchor)


def roi_neighbor_filter(xyz, rois, radius_of_neighbor):
    """``FILTER_NEIGHBOR_WITH_ROI`` (JAX :255-270): support points farther
    than (the nearest RoI's half-diagonal + the radius) from it move to
    ``FAR_SENTINEL``, out of every query ball and interpolation tap."""
    keep = _near_roi(xyz, rois, radius_of_neighbor)
    return torch.where(keep[..., None], xyz, FAR_SENTINEL)


class VoxelSetAbstraction(nn.Module):
    """Keypoints and their multi-source features (JAX :273-382).  model_cfg
    is the yaml's PFE: NUM_KEYPOINTS, NUM_OUTPUT_FEATURES, SAMPLE_METHOD
    (FPS, or SPC with SPC_SAMPLING), FEATURES_SOURCE and SA_LAYER (a
    source's MLPS / POOL_RADIUS / NSAMPLE or VectorPool group config,
    DOWNSAMPLE_FACTOR, MAX_VOXELS for a dense level,
    FILTER_NEIGHBOR_WITH_ROI).  ``level_channels`` maps each backbone level
    to its channels, ``num_bev_features`` is the BEV map's."""

    def __init__(self, model_cfg, voxel_size, point_cloud_range, num_bev_features,
                 level_channels, num_rawpoint_features=4):
        super().__init__()
        cfg = EasyDict(model_cfg)
        if cfg.get("POINT_SOURCE", "raw_points") != "raw_points":
            raise NotImplementedError(f"VSA POINT_SOURCE {cfg.POINT_SOURCE}")
        self.cfg = cfg
        self.num_keypoints = int(cfg.NUM_KEYPOINTS)
        self.method = cfg.get("SAMPLE_METHOD", "FPS")
        if self.method not in ("FPS", "SPC"):
            raise NotImplementedError(f"VSA SAMPLE_METHOD {self.method}")
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        srcs = list(cfg.FEATURES_SOURCE)
        # the order the JAX package concatenates them in
        self.sources = ([s for s in ("bev", "raw_points") if s in srcs]
                        + [s for s in srcs if s not in ("bev", "raw_points")])
        self.source_channels = {}
        for src in self.sources:
            if src == "bev":
                self.source_channels[src] = int(num_bev_features)
                continue
            scfg = EasyDict(cfg.SA_LAYER[src])
            c_in = (int(num_rawpoint_features) - 3 if src == "raw_points"
                    else int(level_channels[src]))
            agg = make_aggregator(scfg, c_in, src)
            self.add_module("SA_rawpoints" if src == "raw_points" else f"SA_{src}", agg)
            self.source_channels[src] = agg.out_channels
        c_out = int(cfg.NUM_OUTPUT_FEATURES)
        self.fusion = Dense(sum(self.source_channels.values()), c_out, bias=False)
        self.fusion_bn = BatchNorm(c_out)

    def aggregator(self, src):
        return getattr(self, "SA_rawpoints" if src == "raw_points" else f"SA_{src}")

    def filtered(self, src, xyz, rois):
        scfg = EasyDict(self.cfg.SA_LAYER[src])
        if scfg.get("FILTER_NEIGHBOR_WITH_ROI", False) and rois is not None:
            return roi_neighbor_filter(xyz, rois, float(scfg.RADIUS_OF_NEIGHBOR_WITH_ROI))
        return xyz

    def voxel_list(self, src, entry, occupancy):
        """A level's (centres, feats, valid): a sparse level's sites, or a
        dense level's first ``MAX_VOXELS`` active cells."""
        scfg = EasyDict(self.cfg.SA_LAYER[src])
        stride = int(scfg.DOWNSAMPLE_FACTOR)
        if isinstance(entry, (tuple, list)):
            return sparse_to_voxel_list(entry, stride, self.voxel_size, self.point_cloud_range)
        return dense_to_voxel_list(entry, occupancy[stride], int(scfg.get("MAX_VOXELS", 8192)),
                                   stride, self.voxel_size, self.point_cloud_range)

    def keypoints(self, points, rois=None):
        """(B, K, 3) keypoints of the raw points (B, N, 3 + C): D-FPS over
        the points, or over SPC's collapse of them on ``rois``."""
        xyz = points[..., 0:3]
        fps_xyz = xyz
        if self.method == "SPC":
            if rois is None:
                raise ValueError("SPC sampling needs the first stage's rois")
            fps_xyz = spc_proximity_collapse(
                xyz, rois, float(EasyDict(self.cfg.SPC_SAMPLING).SAMPLE_RADIUS_WITH_ROI))
        idx = farthest_point_sample(fps_xyz.contiguous(), self.num_keypoints)
        return gather_points(xyz, idx)

    def forward(self, points, multi_scale, occupancy, spatial_features, bev_stride, rois=None):
        """points (B, N, 3 + C); multi_scale ``{level: (coords, feats, valid)}``
        (sparse) or ``{level: (B, Z, Y, X, C)}`` (dense, with ``occupancy``
        of :func:`multi_scale_occupancy`); spatial_features (B, H, W, C) the
        BEV map before the 2-D backbone; rois (B, R, 7+) the proposals (SPC
        and the RoI filter read them) -> ``point_coords`` (B, K, 3),
        ``point_features`` (B, K, F_out), ``point_features_before_fusion``
        (B, K, F_cat)."""
        xyz = points[..., 0:3]
        keypoints = self.keypoints(points, rois)
        feats = []
        for src in self.sources:
            if src == "bev":
                x_idx = div_const(keypoints[..., 0] - self.point_cloud_range[0],
                                  self.voxel_size[0], float(bev_stride))
                y_idx = div_const(keypoints[..., 1] - self.point_cloud_range[1],
                                  self.voxel_size[1], float(bev_stride))
                feats.append(torch.stack([
                    bilinear_interpolate(spatial_features[b], x_idx[b], y_idx[b])
                    for b in range(points.shape[0])]))
            elif src == "raw_points":
                pf = points[..., 3:] if points.shape[-1] > 3 else None
                feats.append(self.aggregator(src)(self.filtered(src, xyz, rois), pf, keypoints))
            else:
                centres, vfeats, _ = self.voxel_list(src, multi_scale[src], occupancy)
                feats.append(self.aggregator(src)(self.filtered(src, centres, rois), vfeats,
                                                  keypoints))
        before_fusion = torch.cat(feats, dim=-1)
        point_features = torch.relu(self.fusion_bn(self.fusion(before_fusion)))
        return {"point_coords": keypoints, "point_features": point_features,
                "point_features_before_fusion": before_fusion}
