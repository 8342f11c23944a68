"""Per-centre neighbour attention on the flat (R, H*hd) layout.

Counterpart of ``pdanet_tpu/ops/pallas/attention.py:201-251``
(``neighbor_attention_flat``): rows are flattened (centre, K) tokens, the K
rows of one centre contiguous; per centre and head,
``softmax(q k^T / sqrt(hd)) v`` over its K tokens, with no mask.  A CUDA
tensor runs the kernel in ``csrc/neighbor_attention.cu``; a CPU tensor runs
:func:`neighbor_attention_flat_plain`.
"""

import math

import torch

from . import cuda_lib

_DTYPES = (torch.float32, torch.bfloat16)


def neighbor_attention_flat(q2, k2, v2, K, H, hd):
    """(R, H*hd) q, k, v -> (R, H*hd) attended values, in the input dtype."""
    if q2.device.type == "cpu":
        return neighbor_attention_flat_plain(q2, k2, v2, K, H, hd)
    return neighbor_attention_flat_cuda(q2, k2, v2, K, H, hd)


def neighbor_attention_flat_plain(q2, k2, v2, K, H, hd):
    """The plain PyTorch version: scaled q, matmul, softmax and matmul in
    float32, result cast to the input dtype."""
    R = q2.shape[0]

    def heads(t):  # (R, H*hd) -> (R/K, H, K, hd)
        return t.float().reshape(R // K, K, H, hd).permute(0, 2, 1, 3)

    q = heads(q2) * (1.0 / math.sqrt(hd))
    s = torch.matmul(q, heads(k2).transpose(-1, -2))  # (R/K, H, K, K)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, heads(v2))  # (R/K, H, K, hd)
    return o.permute(0, 2, 1, 3).reshape(R, H * hd).to(q2.dtype)


def neighbor_attention_flat_cuda(q2, k2, v2, K, H, hd):
    """The kernel: one block per (centre, head)."""
    if q2.dim() != 2 or q2.shape[1] != H * hd or q2.shape[0] % K \
            or k2.shape != q2.shape or v2.shape != q2.shape:
        raise ValueError(
            f"neighbor_attention_flat: q/k/v must be (R, H*hd) with R % K == 0; "
            f"got {tuple(q2.shape)}, K={K}, H={H}, hd={hd}")
    if not (1 <= K <= 64 and 1 <= hd <= 128):
        raise ValueError(f"neighbor_attention_flat: the kernel takes K <= 64 "
                         f"and hd <= 128, got K={K}, hd={hd}")
    cuda_lib.require_cuda("neighbor_attention_flat", q2, k2, v2, dtypes=_DTYPES)
    if not (q2.dtype == k2.dtype == v2.dtype):
        raise TypeError("neighbor_attention_flat: q, k, v must share a dtype")
    if torch.is_grad_enabled() and (q2.requires_grad or k2.requires_grad
                                    or v2.requires_grad):
        raise NotImplementedError(
            "neighbor_attention_flat: the kernel has no backward yet "
            "(ROADMAP queue 2 item 6); run under torch.no_grad()")
    R = q2.shape[0]
    out = torch.empty_like(q2)
    if R == 0:
        return out
    lib = cuda_lib.lib()
    code = lib.pdanet_neighbor_attention(
        cuda_lib.ptr(q2), cuda_lib.ptr(k2), cuda_lib.ptr(v2), cuda_lib.ptr(out),
        R, K, H, hd, int(q2.dtype == torch.bfloat16),
        cuda_lib.stream_handle(q2.device),
    )
    cuda_lib.check(code, "neighbor_attention")
    cuda_lib.launches["neighbor_attention"] += 1
    return out
