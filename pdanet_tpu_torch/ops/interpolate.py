"""Three nearest neighbours and the weighted gather of their features.

Counterparts of ``pdanet_tpu/ops/interpolate.py:15-42`` (``three_nn``,
``three_interpolate``).  No Pallas kernel computes either in the JAX
package: the plain PyTorch versions below are the port, on every device.
The JAX form builds the whole (B, N, M) distance field; PV-RCNN++'s RoI
grid pool asks for 746,496 grid centres x 2048 keypoints a training frame
(gigabytes a field), so this one builds the field over chunks of the
queries.  The index search is the op ``<package>::three_nn`` (the same
plain version for every device), so that ``torch.export`` keeps it as one
call instead of unrolling its chunk loop into the program.
"""

import torch

from . import cuda_lib

# (query x support) distances one chunk of queries materializes
_CHUNK = 1 << 25


def three_nn(unknown, known):
    """The 3 nearest ``known`` points of each ``unknown`` point.

    Args:
        unknown: (B, N, 3); known: (B, M, 3), M >= 3.
    Returns:
        dist2: (B, N, 3) squared distances, nearest first, differentiable
            in both inputs; idx: (B, N, 3) int32.

    The squared distance is ``dx * dx + dy * dy + dz * dz``, component by
    component as the JAX function computes it (not the
    ``|a|^2 + |b|^2 - 2ab`` expansion, which reorders near-ties).  Among
    equal distances the lowest index comes first, as ``lax.top_k`` gives:
    three passes of ``argmin`` (the first minimum), each masking its pick.
    """
    idx = three_nn_indices(unknown, known)
    return picked_dist2(unknown, known, idx), idx


def three_nn_indices(unknown, known):
    """:func:`three_nn`'s (B, N, 3) int32 indices alone, without a
    gradient."""
    return three_nn_op(unknown.detach().contiguous(), known.detach().contiguous())


@torch.library.custom_op(f"{cuda_lib.NAMESPACE}::three_nn", mutates_args=())
def three_nn_op(unknown: torch.Tensor, known: torch.Tensor) -> torch.Tensor:
    """The index search over chunks of the queries."""
    B, N, _ = unknown.shape
    M = known.shape[1]
    if M < 3:
        raise ValueError(f"three_nn: {M} known points, want at least 3")
    chunk = max(1, _CHUNK // M)
    idx = torch.empty((B, N, 3), dtype=torch.int64, device=unknown.device)
    with torch.no_grad():
        for b in range(B):
            kx, ky, kz = (known[b, None, :, c] for c in range(3))
            for n0 in range(0, N, chunk):
                u = unknown[b, n0:n0 + chunk]
                dx, dy, dz = u[:, 0:1] - kx, u[:, 1:2] - ky, u[:, 2:3] - kz
                d2 = dx * dx + dy * dy + dz * dz  # (n, M)
                del dx, dy, dz
                for k in range(3):
                    pick = torch.argmin(d2, dim=-1)
                    idx[b, n0:n0 + chunk, k] = pick
                    d2.scatter_(1, pick[:, None], torch.inf)
    return idx.to(torch.int32)


@three_nn_op.register_fake
def _(unknown, known):
    return unknown.new_empty(unknown.shape[:2] + (3,), dtype=torch.int32)


def picked_dist2(unknown, known, idx):
    """The squared distances (B, N, 3) of the picks ``idx``, with their
    gradient: the same arithmetic on the same values gives the field's
    entries bit for bit."""
    B, N = idx.shape[:2]
    near = torch.gather(known, 1, idx.long().reshape(B, N * 3, 1).expand(B, N * 3, 3))
    d = unknown[:, :, None, :] - near.reshape(B, N, 3, 3)
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def three_interpolate(features, idx, weight):
    """(B, M, C) features x (B, N, 3) indices x (B, N, 3) weights -> (B, N,
    C): each point's three gathered feature rows, weighted and summed
    (``pdanet_tpu/ops/interpolate.py:35-42``); differentiable in the
    features and the weights."""
    B, M, C = features.shape
    N = idx.shape[1]
    gathered = torch.gather(features, 1, idx.long().reshape(B, N * 3, 1).expand(B, N * 3, C))
    return (gathered.reshape(B, N, 3, C) * weight[..., None]).sum(dim=2)
