"""Gather and grouping on channels-last tensors.

Counterpart of ``pdanet_tpu/ops/grouping.py:23-48``.  Indices are clipped
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
