"""Multi-radius first-K ball query with the CUDA first-hit padding.

Counterpart of ``pdanet_tpu/ops/ball_query.py:109-188``.  For each centre
and each (radius, K): the first K support indices in scan order with
``d2 < r2`` (strict, ``r2 = float32(radius * radius)``).  Unfilled slots
repeat the first hit; a centre with no hit gets index 0.  A CUDA tensor
runs the kernel in ``csrc/ball_query.cu``; a CPU tensor runs
:func:`ball_query_multi_plain`.
"""

import ctypes

import numpy as np
import torch

from . import cuda_lib

# (center x point) entries the plain version materializes at once
_PLAIN_CHUNK = 1 << 22


def ball_query(radius, nsample, xyz, new_xyz):
    """(B, N, 3) support x (B, M, 3) centres -> (B, M, nsample) int32."""
    return ball_query_multi((radius,), (nsample,), xyz, new_xyz)[0]


def ball_query_multi(radii, nsamples, xyz, new_xyz):
    """One shared distance field for all radii.

    Returns a tuple of (B, M, nsample_i) int32 index tensors.  The indices
    carry no gradient, so the wrapper takes ``xyz`` and ``new_xyz`` detached.
    """
    xyz, new_xyz = xyz.detach(), new_xyz.detach()
    if xyz.device.type == "cpu":
        return ball_query_multi_plain(radii, nsamples, xyz, new_xyz)
    return ball_query_multi_cuda(radii, nsamples, xyz, new_xyz)


def _r2(radius):
    return float(np.float32(radius * radius))


def ball_query_multi_plain(radii, nsamples, xyz, new_xyz):
    """The plain PyTorch version: hit masks, cumsum ranks and a scatter,
    over chunks of centres."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    dev = xyz.device
    outs = [torch.zeros((B, M, k), dtype=torch.int32, device=dev)
            for k in nsamples]
    iota = torch.arange(N, device=dev)
    chunk = max(1, _PLAIN_CHUNK // max(N, 1))
    for b in range(B):
        for m0 in range(0, M, chunk):
            c = new_xyz[b, m0:m0 + chunk]  # (m, 3)
            dx = c[:, 0:1] - xyz[b, None, :, 0]
            dy = c[:, 1:2] - xyz[b, None, :, 1]
            dz = c[:, 2:3] - xyz[b, None, :, 2]
            d2 = dx * dx + dy * dy + dz * dz  # (m, N)
            for r, (radius, k) in enumerate(zip(radii, nsamples)):
                hit = d2 < _r2(radius)
                rank = torch.cumsum(hit, dim=-1)  # 1-based rank of each hit
                take = hit & (rank <= k)
                slot = torch.where(take, rank - 1, torch.full_like(rank, k))
                sel = torch.zeros((c.shape[0], k + 1), dtype=torch.int64,
                                  device=dev)
                sel.scatter_(1, slot, iota.expand_as(slot))  # slot k: discard
                sel = sel[:, :k]
                total = rank[:, -1:]
                fill = torch.where(total > 0, sel[:, 0:1], 0)
                slots = torch.arange(k, device=dev)[None]
                outs[r][b, m0:m0 + chunk] = torch.where(
                    slots < total, sel, fill).to(torch.int32)
    return tuple(outs)


def ball_query_multi_cuda(radii, nsamples, xyz, new_xyz):
    """The kernel: one warp per centre (``csrc/ball_query.cu``)."""
    if len(radii) != len(nsamples) or not 1 <= len(radii) <= 4:
        raise ValueError("ball_query_multi: 1 to 4 radii, one K each")
    if xyz.dim() != 3 or xyz.shape[2] != 3 or new_xyz.dim() != 3 \
            or new_xyz.shape[2] != 3 or new_xyz.shape[0] != xyz.shape[0]:
        raise ValueError(
            f"ball_query_multi: want (B, N, 3) and (B, M, 3), got "
            f"{tuple(xyz.shape)} and {tuple(new_xyz.shape)}")
    cuda_lib.require_cuda("ball_query_multi", xyz, new_xyz)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    outs = tuple(torch.empty((B, M, int(k)), dtype=torch.int32,
                             device=xyz.device) for k in nsamples)
    n = len(radii)
    r2 = (ctypes.c_float * n)(*(_r2(r) for r in radii))
    ks = (ctypes.c_int * n)(*(int(k) for k in nsamples))
    ptrs = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
    lib = cuda_lib.lib()
    code = lib.pdanet_ball_query(
        cuda_lib.ptr(xyz), cuda_lib.ptr(new_xyz), B, N, M, n,
        ctypes.cast(r2, ctypes.c_void_p), ctypes.cast(ks, ctypes.c_void_p),
        ctypes.cast(ptrs, ctypes.c_void_p), cuda_lib.stream_handle(xyz.device),
    )
    cuda_lib.check(code, "ball_query")
    cuda_lib.launches["ball_query"] += 1
    return outs
