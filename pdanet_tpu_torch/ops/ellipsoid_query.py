"""Ellipsoid query: a data-adaptive neighbourhood search.

Counterpart of ``pdanet_tpu/ops/ellipsoid_query.py:60-141``
(``ellipsoid_query_gpu.cu:311-513``, always called with the axes (r, 2r,
r)), in plain PyTorch on every device: no TPU kernel stands behind it.

1. Stage 1, a sphere query: the first ``nsample`` points in scan order
   with d^2 < r^2, first-hit padding (no hit: index 0); ``cnt`` slots
   filled.
2. Group statistics, where ``cnt >= 3``: the mean of the ``cnt`` points;
   if one of them is exactly (0, 0, 0) the covariance stays 0 and the
   eigenvectors are the identity (the kernel's ``flag``).  Otherwise the
   points are centred on the query centre when |mean - centre| >= r / 4,
   else on the mean, and the covariance is M^T M / (cnt - 1).
3. Stage 2, the re-oriented ellipsoid: a point p (relative to the centre)
   is inside when proj_large^2 / r^2 + proj_mid^2 / (4 r^2) +
   proj_small^2 / r^2 < 1, the long 2r axis on the middle eigenvector.
   The first and third axes are equal, so the membership depends on the
   middle eigenvector alone: ``val = (|p|^2 - proj_mid^2) / r^2 +
   proj_mid^2 / (4 r^2)``, which the solver's choice of basis in the
   plane of the other two cannot change.  Points inside that are not
   already in the slots are appended in scan order up to ``nsample``.

Only ``idx`` is returned; it carries no gradient.
"""

import numpy as np
import torch

from .ball_query import first_hits
from .grouping import group_points

_PLAIN_CHUNK = 1 << 20  # (centre x point) pairs at a time


def _f32(x):
    return float(np.float32(x))


def query_frame(radius, nsample, pts, centers):
    """One frame: (N, 3) points x (m, 3) centres -> (m, nsample) int64
    indices, and each point's ellipsoid value ``val`` and squared distance
    (m, N), whose distances from 1 and r^2 say how near it lies to a
    surface of the query."""
    rel = pts[None, :, :] - centers[:, None, :]  # (m, N, 3)
    d2 = (rel * rel).sum(dim=-1)
    hit = d2 < _f32(radius * radius)
    idx1 = first_hits(hit, nsample)
    cnt = torch.clamp(hit.sum(dim=-1), max=nsample)  # (m,)
    slots = torch.arange(nsample, device=pts.device)
    memb = slots[None, :] < cnt[:, None]  # a slot holding a distinct stage-1 hit

    grouped = pts[idx1]  # (m, K, 3)
    cntf = torch.clamp(cnt, min=1).to(pts.dtype)[:, None]
    mean = torch.where(memb[..., None], grouped, 0.0).sum(dim=-2) / cntf
    flag = (memb & (grouped == 0.0).all(dim=-1)).any(dim=-1)
    dist_mc = torch.linalg.norm(mean - centers, dim=-1)
    sub = torch.where((dist_mc >= radius / 4.0)[:, None], centers, mean)
    mc = torch.where(memb[..., None], grouped - sub[:, None, :], 0.0)
    cov = torch.einsum("mki,mkj->mij", mc, mc) / torch.clamp(cnt - 1, min=1).to(
        pts.dtype)[:, None, None]
    cov = torch.where(flag[:, None, None], 0.0, cov)
    v_mid = torch.linalg.eigh(cov).eigenvectors[..., 1]  # (m, 3), ascending eigenvalues
    v_mid = torch.where(flag[:, None], torch.tensor([0.0, 1.0, 0.0], dtype=pts.dtype,
                                                    device=pts.device), v_mid)

    proj = (rel * v_mid[:, None, :]).sum(dim=-1)  # (m, N)
    p2 = proj * proj
    val = (d2 - p2) / _f32(radius * radius) + p2 / _f32(4.0 * radius * radius)
    rank1 = torch.cumsum(hit, dim=-1) - 1
    already = hit & (rank1 < nsample)
    cand = (val < 1.0) & ~already & (cnt >= 3)[:, None]

    n_cand = cand.sum(dim=-1)
    pos2 = first_hits(cand, nsample)  # (m, K)
    take = slots[None, :] - cnt[:, None]  # the candidate each slot wants
    take_safe = take.clamp(0, nsample - 1)
    use = (take >= 0) & (take_safe < n_cand[:, None])
    return torch.where(use, torch.gather(pos2, 1, take_safe), idx1), val, d2


@torch.no_grad()
def ellipsoid_query(radius, nsample, xyz, new_xyz):
    """(B, N, 3) x (B, M, 3) -> (B, M, nsample) int32 indices; the axes
    (radius, 2 radius, radius), the reference's only instantiation
    (pointnet2_utils.py:314)."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    out = torch.zeros((B, M, nsample), dtype=torch.int32, device=xyz.device)
    chunk = max(1, _PLAIN_CHUNK // max(N, 1))
    for b in range(B):
        for m0 in range(0, M, chunk):
            out[b, m0:m0 + chunk] = query_frame(radius, nsample, xyz[b],
                                                new_xyz[b, m0:m0 + chunk])[0].to(torch.int32)
    return out


def query_and_group_ellipsoid(radius, nsample, xyz, new_xyz, features=None, use_xyz=True):
    """``QueryAndGroup_Ellipsoid`` (pointnet2_utils.py:329-364),
    channels-last: (B, M, K, 3 + C) centre-relative xyz and the grouped
    features, or one of the two (``features`` None / ``use_xyz`` False)."""
    idx = ellipsoid_query(radius, nsample, xyz, new_xyz)
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if features is not None:
        grouped_features = group_points(features, idx)
        if use_xyz:
            return torch.cat([grouped_xyz, grouped_features], dim=-1)
        return grouped_features
    if not use_xyz:
        raise ValueError("query_and_group_ellipsoid: no features and use_xyz False")
    return grouped_xyz
