"""Distance farthest-point sampling (D-FPS).

Counterpart of ``pdanet_tpu/ops/sampling.py:27-83``.  The first index is
always 0, the running min-distance starts at 1e10, and each step takes the
argmax with the lowest index on ties.  The op ``<package>::fps`` runs the
kernel in ``csrc/fps.cu`` for a CUDA tensor and
:func:`farthest_point_sample_plain` for a CPU tensor.
"""

import ctypes

import torch

from . import cuda_lib


def farthest_point_sample(xyz, npoint):
    """(B, N, 3) -> (B, npoint) int32 indices, computed in float32 on every
    device.  The indices carry no gradient, so the wrapper takes ``xyz``
    detached."""
    return fps_op(xyz.detach(), int(npoint))


def farthest_point_sample_plain(xyz, npoint):
    """The plain PyTorch version: one step of the loop per sample."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    temp = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    idxs = torch.zeros((B, npoint), dtype=torch.int64, device=xyz.device)
    old = torch.zeros((B,), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for j in range(1, npoint):
        cur = xyz[rows, old]  # (B, 3)
        dx = xyz[..., 0] - cur[:, 0:1]
        dy = xyz[..., 1] - cur[:, 1:2]
        dz = xyz[..., 2] - cur[:, 2:3]
        d = dx * dx + dy * dy + dz * dz
        temp = torch.minimum(temp, d)
        old = torch.argmax(temp, dim=-1)  # first maximum
        idxs[:, j] = old
    return idxs.to(torch.int32)


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
