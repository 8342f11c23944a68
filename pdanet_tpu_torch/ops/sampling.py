"""Farthest-point sampling: D-FPS, F-FPS and the sector FPS.

Counterpart of ``pdanet_tpu/ops/sampling.py``.  The first index is always
0, the running min-distance starts at 1e10, and each step takes the argmax
with the lowest index on ties.

- D-FPS (:27-83): the op ``<package>::fps`` runs the kernel in
  ``csrc/fps.cu`` for a CUDA tensor and :func:`farthest_point_sample_plain`
  for a CPU tensor.
- F-FPS (:108-137), FPS over feature-space distances recomputed one row a
  step: the op ``<package>::fps_features`` runs the kernel in
  ``csrc/fps_features.cu`` for a CUDA tensor and
  :func:`farthest_point_sample_features_plain` for a CPU tensor.  Both sum
  a distance's channels in channel order with round-to-nearest adds and no
  fused multiply-add, so the card and the plain version pick the same
  indices.
- ``farthest_point_sample_with_dist`` (:86-105), FPS over a given (B, N, N)
  matrix, and ``calc_square_dist`` (:140-150): plain PyTorch; no model
  calls them.
- ``ds_fps`` / ``ry_fps`` (:153-181): each cloud sorted by a key (stable),
  cut into 4 sectors, D-FPS on every sector; the B x 4 sectors go to the
  D-FPS op as one batch of clouds.
"""

import ctypes

import torch

from . import cuda_lib


def farthest_point_sample(xyz, npoint):
    """(B, N, 3) -> (B, npoint) int32 indices, computed in float32 on every
    device.  The indices carry no gradient, so the wrapper takes ``xyz``
    detached."""
    return fps_op(xyz.detach(), int(npoint))


def _fps_over_rows(B, N, npoint, row_dist, device):
    """The FPS loop over a distance row ``row_dist(old)`` (B, N) float32 of
    the last picks ``old`` (B,)."""
    temp = torch.full((B, N), 1e10, dtype=torch.float32, device=device)
    idxs = torch.zeros((B, npoint), dtype=torch.int64, device=device)
    old = torch.zeros((B,), dtype=torch.int64, device=device)
    for j in range(1, npoint):
        temp = torch.minimum(temp, row_dist(old))
        old = torch.argmax(temp, dim=-1)  # first maximum
        idxs[:, j] = old
    return idxs.to(torch.int32)


def farthest_point_sample_plain(xyz, npoint):
    """The plain PyTorch version: one step of the loop per sample, the
    distance ``dx*dx + dy*dy + dz*dz`` left to right."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    rows = torch.arange(B, device=xyz.device)

    def row_dist(old):
        cur = xyz[rows, old]  # (B, 3)
        dx = xyz[..., 0] - cur[:, 0:1]
        dy = xyz[..., 1] - cur[:, 1:2]
        dz = xyz[..., 2] - cur[:, 2:3]
        return dx * dx + dy * dy + dz * dz

    return _fps_over_rows(B, N, int(npoint), row_dist, xyz.device)


def fps_config(N):
    """The kernel's launch shape for N points: (cluster size, threads per
    CTA, points per thread in registers -- 0 when the points and the
    running distance live in global memory --, 1 if the chunk skip is on),
    as ``csrc/fps.cu`` ``config`` picks it."""
    cfg = (ctypes.c_int * 4)()
    cuda_lib.lib().pdanet_fps_config(int(N), ctypes.cast(cfg, ctypes.c_void_p))
    return tuple(cfg)


@cuda_lib.on_tensor_device
def farthest_point_sample_cuda(xyz, npoint):
    """The kernel: one thread-block cluster per frame (``csrc/fps.cu``), in
    the launch shape :func:`fps_config` gives.  A refused launch (no room
    for the cluster) raises with its CUDA error."""
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"farthest_point_sample: xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    cuda_lib.require_cuda("farthest_point_sample", xyz)
    B, N, _ = xyz.shape
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0 or npoint == 0:
        return out
    if N == 0:
        raise ValueError("farthest_point_sample: empty cloud")
    soa = xyz.permute(0, 2, 1).contiguous()  # (B, 3, N) planes
    # the running distance lives in registers unless the cloud is too large
    temp = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
            if fps_config(N)[2] == 0 else None)
    code = cuda_lib.lib().pdanet_fps(
        cuda_lib.ptr(soa), B, N, npoint,
        cuda_lib.ptr(temp) if temp is not None else None,
        cuda_lib.ptr(out), cuda_lib.stream_handle(xyz.device),
    )
    cuda_lib.check(code, "fps")
    cuda_lib.launches["fps"] += 1
    cuda_lib.launches_by_k[f"fps_n{N}"] += 1
    return out


@torch.library.custom_op(f"{cuda_lib.NAMESPACE}::fps", mutates_args=(), device_types="cpu")
def fps_op(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return farthest_point_sample_plain(xyz, npoint)


@fps_op.register_kernel("cuda")
def _(xyz, npoint):
    # the kernel computes in float32, as the plain version does: a float64
    # cloud (a float64 model's) is rounded first
    return farthest_point_sample_cuda(xyz.float().contiguous(), npoint)


@fps_op.register_fake
def _(xyz, npoint):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


def farthest_point_sample_with_dist(dist, npoint):
    """FPS over a precomputed (B, N, N) distance matrix:
    (B, npoint) int32.  Plain PyTorch; the oracle of F-FPS."""
    B, N, _ = dist.shape
    dist = dist.float()
    rows = torch.arange(B, device=dist.device)
    return _fps_over_rows(B, N, int(npoint), lambda old: dist[rows, old], dist.device)


def calc_square_dist(a, b):
    """Pairwise squared L2 distances (B, n, c) x (B, m, c) -> (B, n, m),
    ``||a||^2 + ||b||^2 - 2 a.b`` (un-rooted)."""
    a_sq = (a * a).sum(dim=-1)[..., :, None]
    b_sq = (b * b).sum(dim=-1)[..., None, :]
    return a_sq + b_sq - 2.0 * torch.einsum("bnc,bmc->bnm", a, b)


def farthest_point_sample_features(feats, npoint):
    """F-FPS: (B, N, C) rows -> (B, npoint) int32, FPS over the squared
    distances of the rows, one distance row recomputed a step (O(N)
    memory), computed in float32 on every device.  The indices carry no
    gradient, so the wrapper takes ``feats`` detached."""
    return fps_features_op(feats.detach().float().contiguous(), int(npoint))


def feature_row_dist(feats, cur):
    """Squared distances of the rows of ``feats`` (B, N, C) to ``cur``
    (B, C): the channels' squares summed in channel order, one rounding a
    step, as ``csrc/fps_features.cu`` sums them."""
    diff = feats - cur[:, None, :]
    sq = diff * diff
    d = sq[..., 0]
    for c in range(1, sq.shape[-1]):
        d = d + sq[..., c]
    return d


def farthest_point_sample_features_plain(feats, npoint):
    """The plain PyTorch version of F-FPS: one step of the loop per sample,
    each distance summed channel by channel (:func:`feature_row_dist`)."""
    B, N, _ = feats.shape
    feats = feats.float()
    rows = torch.arange(B, device=feats.device)
    return _fps_over_rows(B, N, int(npoint),
                          lambda old: feature_row_dist(feats, feats[rows, old]), feats.device)


def fps_features_config(N, C):
    """The F-FPS kernel's launch shape for N rows of C channels: (cluster
    size, threads per CTA, 1 if the rows are staged in shared memory -- 0
    when they are read from global memory --, bytes of dynamic shared
    memory), as ``csrc/fps_features.cu`` ``config`` picks it."""
    cfg = (ctypes.c_int * 4)()
    cuda_lib.lib().pdanet_fps_features_config(int(N), int(C), ctypes.cast(cfg, ctypes.c_void_p))
    return tuple(cfg)


@cuda_lib.on_tensor_device
def farthest_point_sample_features_cuda(feats, npoint):
    """The kernel: one thread-block cluster per frame, each CTA holding a
    slice of the rows in shared memory (``csrc/fps_features.cu``), in the
    launch shape :func:`fps_features_config` gives.  A refused launch
    raises with its CUDA error."""
    if feats.dim() != 3:
        raise ValueError(f"farthest_point_sample_features: feats must be (B, N, C), got "
                         f"{tuple(feats.shape)}")
    cuda_lib.require_cuda("farthest_point_sample_features", feats)
    B, N, C = feats.shape
    out = torch.empty((B, npoint), dtype=torch.int32, device=feats.device)
    if B == 0 or npoint == 0:
        return out
    if N == 0 or C == 0:
        raise ValueError("farthest_point_sample_features: empty cloud")
    # the running distance in global memory when the rows are
    temp = (torch.empty((B, N), dtype=torch.float32, device=feats.device)
            if fps_features_config(N, C)[2] == 0 else None)
    code = cuda_lib.lib().pdanet_fps_features(
        cuda_lib.ptr(feats), B, N, C, npoint,
        cuda_lib.ptr(temp) if temp is not None else None,
        cuda_lib.ptr(out), cuda_lib.stream_handle(feats.device))
    cuda_lib.check(code, "fps_features")
    cuda_lib.launches["fps_features"] += 1
    return out


@torch.library.custom_op(f"{cuda_lib.NAMESPACE}::fps_features", mutates_args=(),
                         device_types="cpu")
def fps_features_op(feats: torch.Tensor, npoint: int) -> torch.Tensor:
    return farthest_point_sample_features_plain(feats, npoint)


fps_features_op.register_kernel("cuda")(farthest_point_sample_features_cuda)


@fps_features_op.register_fake
def _(feats, npoint):
    return feats.new_empty((feats.shape[0], npoint), dtype=torch.int32)


PARTS = 4  # sectors of ds_FPS / ry_FPS (pointnet2_modules.py:1595-1642)


def _sector_fps(xyz, npoint, keys):
    """Sort each cloud by ``keys`` (B, N) (stable, NaN last as in JAX), cut
    it into ``PARTS`` contiguous sectors, take npoint / PARTS D-FPS picks in
    each (the B x PARTS sectors as one batch of clouds) and map them back
    to the cloud's indices: (B, npoint) int32."""
    B, N, _ = xyz.shape
    if N % PARTS or npoint % PARTS:
        raise ValueError(f"sector FPS: N {N} and npoint {npoint} must divide by {PARTS}")
    order = torch.sort(keys, dim=-1, stable=True).indices
    xyz_sorted = torch.gather(xyz, 1, order[..., None].expand(B, N, 3))
    xyz_div = xyz_sorted.reshape(B * PARTS, N // PARTS, 3)
    idx_div = order.reshape(B * PARTS, N // PARTS)
    sampled = farthest_point_sample(xyz_div.contiguous(), npoint // PARTS)
    picked = torch.gather(idx_div, 1, sampled.long())
    return picked.reshape(B, npoint).to(torch.int32)


def ds_fps(xyz, npoint):
    """Radial-sector FPS ('ds_FPS'): sectors of the range ``|p| - 5``,
    computed in float32 as the JAX package does (``(x^2 + y^2) + z^2``,
    rooted)."""
    p = xyz.detach().float()
    r2 = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]
    return _sector_fps(p, npoint, torch.sqrt(r2) - 5.0)


def ry_fps(xyz, npoint):
    """Azimuth-sector FPS ('ry_FPS'): sectors of ``atan(x / y)``, the
    float32 quotient's arctangent taken in float64 and rounded once, so
    that every device sorts the same keys (float32 ``atan`` differs in the
    last place between the CPU and CUDA).  ``y = 0`` gives +-pi/2 and
    ``x = y = 0`` NaN, sorted last."""
    p = xyz.detach().float()
    keys = torch.atan((p[..., 0] / p[..., 1]).double()).float()
    return _sector_fps(p, npoint, keys)
