"""Per-centre neighbour attention on the flat (R, H*hd) layout, with its
gradient.

Counterpart of ``pdanet_tpu/ops/pallas/attention.py:201-319``
(``neighbor_attention_flat`` and ``neighbor_attention_flat_trainable``):
rows are flattened (centre, K) tokens, the K rows of one centre
contiguous; per centre and head, ``softmax(q k^T / sqrt(hd)) v`` over its K
tokens, with no mask.  A CUDA tensor runs the kernels in
``csrc/neighbor_attention.cu`` (forward) and
``csrc/neighbor_attention_bwd.cu`` (backward), in float32 or bfloat16
(float64 too, for exact checks); a CPU tensor runs
:func:`neighbor_attention_flat_plain` and
:func:`neighbor_attention_flat_bwd_plain`.  Under autograd the call goes
through :class:`NeighborAttention`, whose backward recomputes the softmax.
"""

import math

import torch

from . import cuda_lib

# element type codes of the kernels' C interface (csrc/attention_common.cuh)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_SMEM_LIMIT = 232448  # bytes of shared memory a block may opt in to


def neighbor_attention_flat(q2, k2, v2, K, H, hd):
    """(R, H*hd) q, k, v -> (R, H*hd) attended values, in the input dtype."""
    if torch.is_grad_enabled() and (q2.requires_grad or k2.requires_grad
                                    or v2.requires_grad):
        return NeighborAttention.apply(q2, k2, v2, K, H, hd)
    return _forward(q2, k2, v2, K, H, hd)


def _forward(q2, k2, v2, K, H, hd):
    if q2.device.type == "cpu":
        return neighbor_attention_flat_plain(q2, k2, v2, K, H, hd)
    return neighbor_attention_flat_cuda(q2, k2, v2, K, H, hd)


def neighbor_attention_flat_bwd(q2, k2, v2, do2, K, H, hd):
    """(dq, dk, dv) of :func:`neighbor_attention_flat` for the output
    cotangent ``do2``, each (R, H*hd) in the input dtype."""
    if q2.device.type == "cpu":
        return neighbor_attention_flat_bwd_plain(q2, k2, v2, do2, K, H, hd)
    return neighbor_attention_flat_bwd_cuda(q2, k2, v2, do2, K, H, hd)


class NeighborAttention(torch.autograd.Function):
    """The attention with its hand-written backward: the forward keeps
    only q, k and v, and the backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, q2, k2, v2, K, H, hd):
        ctx.save_for_backward(q2, k2, v2)
        ctx.shape = (K, H, hd)
        return _forward(q2, k2, v2, K, H, hd)

    @staticmethod
    def backward(ctx, do2):
        q2, k2, v2 = ctx.saved_tensors
        dq, dk, dv = neighbor_attention_flat_bwd(
            q2, k2, v2, do2.to(q2.dtype).contiguous(), *ctx.shape)
        return dq, dk, dv, None, None, None


def _heads(t, K, H, hd, dtype):  # (R, H*hd) -> (R/K, H, K, hd)
    return t.to(dtype).reshape(t.shape[0] // K, K, H, hd).permute(0, 2, 1, 3)


def _flat(t, dtype):  # (R/K, H, K, hd) -> (R, H*hd)
    C, H, K, hd = t.shape
    return t.permute(0, 2, 1, 3).reshape(C * K, H * hd).to(dtype)


def neighbor_attention_flat_plain(q2, k2, v2, K, H, hd):
    """The plain PyTorch version: scaled q, matmul, softmax and matmul in
    float32 (float64 for float64 input), result cast to the input dtype."""
    ct = torch.promote_types(q2.dtype, torch.float32)
    q = _heads(q2, K, H, hd, ct) * (1.0 / math.sqrt(hd))
    s = torch.matmul(q, _heads(k2, K, H, hd, ct).transpose(-1, -2))  # (C, H, K, K)
    p = torch.softmax(s, dim=-1)
    return _flat(torch.matmul(p, _heads(v2, K, H, hd, ct)), q2.dtype)


def neighbor_attention_flat_bwd_plain(q2, k2, v2, do2, K, H, hd):
    """The plain backward: the explicit recompute formulas in float32
    (float64 for float64 input), not autograd --
    ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P (dP - rowsum(dP P))``,
    ``dQ = s dS K``, ``dK = s dS^T Q``, ``s = 1/sqrt(hd)``."""
    ct = torch.promote_types(q2.dtype, torch.float32)
    s = 1.0 / math.sqrt(hd)
    q, k, v, do = (_heads(t, K, H, hd, ct) for t in (q2, k2, v2, do2))
    p = torch.softmax(torch.matmul(q * s, k.transpose(-1, -2)), dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k) * s
    dk = torch.matmul(ds.transpose(-1, -2), q) * s
    return tuple(_flat(t, q2.dtype) for t in (dq, dk, dv))


def _check_shapes(name, K, H, hd, *tensors, tiles):
    """Validate the tensors of a kernel; ``tiles(elem_bytes)`` is the
    kernel's shared memory in bytes."""
    q2 = tensors[0]
    if q2.dim() != 2 or q2.shape[1] != H * hd or q2.shape[0] % K \
            or any(t.shape != q2.shape for t in tensors):
        raise ValueError(
            f"{name}: tensors must be (R, H*hd) with R % K == 0; "
            f"got {tuple(q2.shape)}, K={K}, H={H}, hd={hd}")
    if not (1 <= K <= 64 and 1 <= hd <= 128):
        raise ValueError(f"{name}: the kernel takes K <= 64 and hd <= 128, "
                         f"got K={K}, hd={hd}")
    cuda_lib.require_cuda(name, *tensors, dtypes=tuple(_DTYPE_CODES))
    if any(t.dtype != q2.dtype for t in tensors):
        raise TypeError(f"{name}: all tensors must share a dtype")
    smem = tiles(8 if q2.dtype == torch.float64 else 4)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: K={K}, hd={hd} in {q2.dtype} needs {smem} bytes of "
                         f"shared memory, above the {_SMEM_LIMIT} a block may have")


def neighbor_attention_flat_cuda(q2, k2, v2, K, H, hd):
    """The forward kernel: one block per (centre, head)."""
    _check_shapes("neighbor_attention_flat", K, H, hd, q2, k2, v2,
                  tiles=lambda b: (3 * K * (hd + 1) + K * (K + 1)) * b)
    R = q2.shape[0]
    out = torch.empty_like(q2)
    if R == 0:
        return out
    lib = cuda_lib.lib()
    code = lib.pdanet_neighbor_attention(
        cuda_lib.ptr(q2), cuda_lib.ptr(k2), cuda_lib.ptr(v2), cuda_lib.ptr(out),
        R, K, H, hd, _DTYPE_CODES[q2.dtype], cuda_lib.stream_handle(q2.device),
    )
    cuda_lib.check(code, "neighbor_attention")
    cuda_lib.launches["neighbor_attention"] += 1
    return out


def neighbor_attention_flat_bwd_cuda(q2, k2, v2, do2, K, H, hd):
    """The backward kernel: one block per (centre, head), softmax
    recomputed, no atomics."""
    _check_shapes("neighbor_attention_flat_bwd", K, H, hd, q2, k2, v2, do2,
                  tiles=lambda b: (4 * K * (hd + 1) + 2 * K * (K + 1)) * b)
    R = q2.shape[0]
    dq, dk, dv = (torch.empty_like(q2) for _ in range(3))
    if R == 0:
        return dq, dk, dv
    lib = cuda_lib.lib()
    code = lib.pdanet_neighbor_attention_bwd(
        cuda_lib.ptr(q2), cuda_lib.ptr(k2), cuda_lib.ptr(v2), cuda_lib.ptr(do2),
        cuda_lib.ptr(dq), cuda_lib.ptr(dk), cuda_lib.ptr(dv),
        R, K, H, hd, _DTYPE_CODES[q2.dtype], cuda_lib.stream_handle(q2.device),
    )
    cuda_lib.check(code, "neighbor_attention_bwd")
    cuda_lib.launches["neighbor_attention_bwd"] += 1
    return dq, dk, dv
