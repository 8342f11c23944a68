"""Distance farthest-point sampling (D-FPS).

Counterpart of ``pdanet_tpu/ops/sampling.py:27-83``.  The first index is
always 0, the running min-distance starts at 1e10, and each step takes the
argmax with the lowest index on ties.  A CUDA tensor runs the kernel in
``csrc/fps.cu``; a CPU tensor runs :func:`farthest_point_sample_plain`.
"""

import torch

from . import cuda_lib


def farthest_point_sample(xyz, npoint):
    """(B, N, 3) float32 -> (B, npoint) int32 indices.  The indices carry
    no gradient, so the wrapper takes ``xyz`` detached."""
    xyz = xyz.detach()
    if xyz.device.type == "cpu":
        return farthest_point_sample_plain(xyz, npoint)
    return farthest_point_sample_cuda(xyz, npoint)


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


def farthest_point_sample_cuda(xyz, npoint):
    """The kernel: one CTA per frame (``csrc/fps.cu``)."""
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"farthest_point_sample: xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    cuda_lib.require_cuda("farthest_point_sample", xyz)
    B, N, _ = xyz.shape
    soa = xyz.permute(0, 2, 1).contiguous()  # (B, 3, N) planes
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0 or npoint == 0:
        return out
    # min-distances live in registers up to 32768 points, else in scratch
    temp = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
            if N > 32768 else None)
    lib = cuda_lib.lib()
    code = lib.pdanet_fps(
        cuda_lib.ptr(soa), B, N, npoint,
        cuda_lib.ptr(temp) if temp is not None else None,
        cuda_lib.ptr(out), cuda_lib.stream_handle(xyz.device),
    )
    cuda_lib.check(code, "fps")
    cuda_lib.launches["fps"] += 1
    return out
