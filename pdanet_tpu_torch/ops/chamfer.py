"""Chamfer distance (bidirectional nearest neighbour) as plain tensor code.

Counterpart of ``pdanet_tpu/ops/chamfer.py:14-41``.  On the PDA-SSD path
it feeds the ``CD_loss`` scalar, logged with no gradient and weighted out
of the total loss (IASSD_head.py:730).
"""

import torch


def chamfer_distance(xyz1, xyz2):
    """(B, N, 3) x (B, M, 3) -> (min squared distance of each xyz1 point
    to xyz2 (B, N), and of each xyz2 point to xyz1 (B, M))."""
    dx = xyz1[:, :, 0:1] - xyz2[:, None, :, 0]
    dy = xyz1[:, :, 1:2] - xyz2[:, None, :, 1]
    dz = xyz1[:, :, 2:3] - xyz2[:, None, :, 2]
    d = dx * dx + dy * dy + dz * dz  # (B, N, M)
    return d.min(dim=2).values, d.min(dim=1).values


def cd_loss_l1(pcs1, pcs2):
    """The reference's L1 chamfer loss as executed (cd_loss.py:22-25): the
    ``dist2`` square root is commented out there, so the value is
    ``(mean(sqrt d1) + mean(d2)) / 2``."""
    d1, d2 = chamfer_distance(pcs1, pcs2)
    return (torch.sqrt(torch.clamp(d1, min=0.0)).mean() + d2.mean()) / 2.0
