"""Gather, grouping and the neighbours' Gaussian density on channels-last
tensors.

Counterpart of ``pdanet_tpu/ops/grouping.py:23-66``.  Indices are clipped
to [0, N - 1] as in the JAX package, so a stray index reads a clamped row
of its own frame.
"""

import torch


def gather_points(features, idx):
    """(B, N, C) x (B, M) int -> (B, M, C)."""
    B, N, C = features.shape
    safe = idx.long().clamp(0, N - 1)
    return torch.gather(features, 1, safe[..., None].expand(B, idx.shape[1], C))


def group_points(features, idx):
    """(B, N, C) x (B, M, K) int -> (B, M, K, C)."""
    B, N, C = features.shape
    M, K = idx.shape[1], idx.shape[2]
    flat = gather_points(features, idx.reshape(B, M * K))
    return flat.reshape(B, M, K, C)


def gaussian_density(grouped_xyz, centers, radius):
    """Gaussian density of each neighbour about its centre
    (``QueryAndGroup_alone_grouped_density_directional``,
    pointnet2_utils.py:594-597; JAX ``grouping.py:51-66``):
    (B, M, K, 3) absolute neighbours x (B, M, 3) centres -> (B, M, K)
    ``exp(-d^2 / (2 r^2)) / (2.5 r)``."""
    rel = grouped_xyz - centers[:, :, None, :]
    d2 = torch.sum(rel * rel, dim=-1)
    return torch.exp(-d2 / (2.0 * radius * radius)) / (2.5 * radius)
