"""Multi-radius first-K ball query with the CUDA first-hit padding, and
the dilated (annulus) query.

Counterpart of ``pdanet_tpu/ops/ball_query.py:109-224``.  For each centre
and each (radius, K): the first K support indices in scan order with
``d2 < r2`` (strict, ``r2 = float32(radius * radius)``).  Unfilled slots
repeat the first hit; a centre with no hit gets index 0.  The op
``<package>::ball_query`` runs the kernel in ``csrc/ball_query.cu`` for a
CUDA tensor and :func:`ball_query_multi_plain` for a CPU tensor.  A caller
may name its ``site`` (a PV-RCNN feature source, its RoI grid pool): the
kernel's launches are then counted once more under ``ball_query_<site>``
(``cuda_lib.launches_by_site``); the op carries the name, so a saved
program counts the same.
"""

import ctypes

import numpy as np
import torch

from . import cuda_lib

# (center x point) entries the plain version materializes at once
_PLAIN_CHUNK = 1 << 22


def ball_query(radius, nsample, xyz, new_xyz, site=""):
    """(B, N, 3) support x (B, M, 3) centres -> (B, M, nsample) int32."""
    return ball_query_multi((radius,), (nsample,), xyz, new_xyz, site)[0]


def ball_query_multi(radii, nsamples, xyz, new_xyz, site=""):
    """One shared distance field for all radii.

    Returns a tuple of (B, M, nsample_i) int32 index tensors.  The indices
    carry no gradient, so the wrapper takes ``xyz`` and ``new_xyz`` detached.
    The kernel computes in float32 (a float64 input rounded), the plain
    version in the inputs' dtype.
    """
    return tuple(ball_query_op([float(r) for r in radii], [int(k) for k in nsamples],
                               xyz.detach(), new_xyz.detach(), str(site)))


def _r2(radius):
    return float(np.float32(radius * radius))


def first_hits(hit, k):
    """(m, n) bool -> (m, k) int64: the positions of each row's first k
    hits in scan order, unfilled slots repeating the first hit, a row with
    no hit all 0 (the CUDA kernels' padding)."""
    rank = torch.cumsum(hit, dim=-1)  # 1-based rank of each hit
    take = hit & (rank <= k)
    slot = torch.where(take, rank - 1, torch.full_like(rank, k))
    sel = torch.zeros((hit.shape[0], k + 1), dtype=torch.int64, device=hit.device)
    iota = torch.arange(hit.shape[-1], device=hit.device)
    sel.scatter_(1, slot, iota.expand_as(slot))  # slot k: discard
    sel = sel[:, :k]
    total = rank[:, -1:]
    fill = torch.where(total > 0, sel[:, 0:1], 0)
    slots = torch.arange(k, device=hit.device)[None]
    return torch.where(slots < total, sel, fill)


def _center_d2(c, pts):
    """(m, 3) centres x (N, 3) points -> (m, N) squared distances, the
    centre minus the point, summed x, y, z."""
    dx = c[:, 0:1] - pts[None, :, 0]
    dy = c[:, 1:2] - pts[None, :, 1]
    dz = c[:, 2:3] - pts[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def ball_query_multi_plain(radii, nsamples, xyz, new_xyz):
    """The plain PyTorch version: hit masks, cumsum ranks and a scatter,
    over chunks of centres."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    outs = [torch.zeros((B, M, k), dtype=torch.int32, device=xyz.device)
            for k in nsamples]
    chunk = max(1, _PLAIN_CHUNK // max(N, 1))
    for b in range(B):
        for m0 in range(0, M, chunk):
            d2 = _center_d2(new_xyz[b, m0:m0 + chunk], xyz[b])  # (m, N)
            for r, (radius, k) in enumerate(zip(radii, nsamples)):
                outs[r][b, m0:m0 + chunk] = first_hits(d2 < _r2(radius), k).to(torch.int32)
    return tuple(outs)


def ball_query_dilated(max_radius, min_radius, nsample, xyz, new_xyz):
    """The annulus query (``ball_query_dilated_kernel_fast``,
    ball_query_gpu.cu:70-117; JAX ``ball_query.py:192-224``): (B, N, 3) x
    (B, M, 3) -> (B, M, nsample) int32, the first hits in scan order with
    ``min_radius^2 <= d^2 < max_radius^2``, first-hit padding.  As in the
    CUDA kernel, a point at d = 0 is admitted once for ``d == 0`` and once
    more when the annulus admits it too (``min_radius == 0``): each point
    holds two slots of the scan, (2n, d == 0) and (2n + 1, annulus).
    Plain PyTorch on every device, over chunks of centres."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    out = torch.zeros((B, M, nsample), dtype=torch.int32, device=xyz.device)
    rmax2, rmin2 = _r2(max_radius), _r2(min_radius)
    chunk = max(1, _PLAIN_CHUNK // max(2 * N, 1))
    for b in range(B):
        for m0 in range(0, M, chunk):
            d2 = _center_d2(new_xyz[b, m0:m0 + chunk], xyz[b])
            hit = torch.stack([d2 == 0, (d2 >= rmin2) & (d2 < rmax2)], dim=-1)
            pos = first_hits(hit.reshape(d2.shape[0], 2 * N), nsample)
            out[b, m0:m0 + chunk] = (pos // 2).to(torch.int32)
    return out


@cuda_lib.on_tensor_device
def ball_query_multi_cuda(radii, nsamples, xyz, new_xyz, stats=None, site=""):
    """The kernel: one CTA per block of centres, the support staged
    through shared memory, tiles out of reach skipped (``csrc/ball_query.cu``).
    ``stats``, a (3,) int64 CUDA tensor, receives the (tile tests, tiles
    within reach, tiles scanned) counts of the call added to it; a launch
    with a ``site`` is also counted under ``ball_query_<site>``."""
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
    ptrs = (ctypes.c_void_p * n)(*(cuda_lib.ptr(o) for o in outs))
    lib = cuda_lib.lib()
    code = lib.pdanet_ball_query(
        cuda_lib.ptr(xyz), cuda_lib.ptr(new_xyz), B, N, M, n,
        ctypes.cast(r2, ctypes.c_void_p), ctypes.cast(ks, ctypes.c_void_p),
        ctypes.cast(ptrs, ctypes.c_void_p),
        cuda_lib.ptr(stats) if stats is not None else None,
        cuda_lib.stream_handle(xyz.device),
    )
    cuda_lib.check(code, "ball_query")
    cuda_lib.launches["ball_query"] += 1
    if site:
        cuda_lib.launches_by_site[f"ball_query_{site}"] += 1
    return outs


@torch.library.custom_op(f"{cuda_lib.NAMESPACE}::ball_query", mutates_args=(),
                         device_types="cpu")
def ball_query_op(radii: list[float], nsamples: list[int], xyz: torch.Tensor,
                  new_xyz: torch.Tensor, site: str) -> list[torch.Tensor]:
    return list(ball_query_multi_plain(radii, nsamples, xyz, new_xyz))


@ball_query_op.register_kernel("cuda")
def _(radii, nsamples, xyz, new_xyz, site):
    # the kernel computes in float32: float64 points (a float64 model's) are
    # rounded first, where the plain version computes in their own dtype
    return list(ball_query_multi_cuda(radii, nsamples, xyz.float().contiguous(),
                                      new_xyz.float().contiguous(), site=site))


@ball_query_op.register_fake
def _(radii, nsamples, xyz, new_xyz, site):
    B, M = new_xyz.shape[:2]
    return [xyz.new_empty((B, M, k), dtype=torch.int32) for k in nsamples]
