"""Per-centre neighbour attention on the flat (R, H*hd) layout, with its
gradient.

Counterpart of ``pdanet_tpu/ops/pallas/attention.py:201-319``
(``neighbor_attention_flat`` and ``neighbor_attention_flat_trainable``):
rows are flattened (centre, K) tokens, the K rows of one centre
contiguous; per centre and head, ``softmax(q k^T / sqrt(hd)) v`` over its K
tokens, with no mask.  A CUDA tensor runs a hand-written kernel chosen by
its dtype:

- bfloat16 (what the PDA-SSD yaml ships for serving and training): the
  tensor-core kernels ``csrc/neighbor_attention_mma.cu`` (forward) and
  ``csrc/neighbor_attention_bwd_mma.cu`` (backward), which round to
  bfloat16 where the TPU kernel does;
- float32 and float64: the SIMT kernels ``csrc/neighbor_attention.cu`` and
  ``csrc/neighbor_attention_bwd.cu``, with every sum in the input type and
  explicit FMAs: four warps per (centre, head) (per two at K <= 16),
  each lane's rows in registers against broadcast 16-byte shared-memory
  loads of the rows all lanes of a warp share, tiles copied by
  ``cp.async``.
  float32 on the tensor cores would mean TF32, and the float32 frame and
  the float64 train step are held index for index and to rounding against
  the CPU.

The ops ``<package>::neighbor_attention`` and
``<package>::neighbor_attention_bwd`` run those kernels for a CUDA tensor
and :func:`neighbor_attention_flat_plain` /
:func:`neighbor_attention_flat_bwd_plain` for a CPU tensor.  The forward
op's gradient (``torch.library.register_autograd``) keeps only q, k and v
and calls the backward op, which recomputes the softmax.
"""

import math

import torch

from . import cuda_lib

# element type codes of the SIMT kernels' C interface (csrc/attention_common.cuh)
_SIMT_CODES = {torch.float32: 0, torch.float64: 2}
_DTYPES = (torch.bfloat16, *_SIMT_CODES)
_SMEM_LIMIT = 232448  # bytes of shared memory a block may opt in to


def neighbor_attention_flat(q2, k2, v2, K, H, hd):
    """(R, H*hd) q, k, v -> (R, H*hd) attended values, in the input dtype."""
    return attention_op(q2, k2, v2, int(K), int(H), int(hd))


def neighbor_attention_flat_bwd(q2, k2, v2, do2, K, H, hd):
    """(dq, dk, dv) of :func:`neighbor_attention_flat` for the output
    cotangent ``do2``, each (R, H*hd) in the input dtype."""
    return tuple(attention_bwd_op(q2, k2, v2, do2, int(K), int(H), int(hd)))


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


def _shape_rule(name, K, hd, dtype):
    """The shapes each kernel takes: K <= 64 and hd <= 128; the bfloat16
    tensor-core kernels also need hd a multiple of 16 (mma tiles)."""
    if not (1 <= K <= 64 and 1 <= hd <= 128):
        raise ValueError(f"{name}: the kernel takes K <= 64 and hd <= 128, "
                         f"got K={K}, hd={hd}")
    if dtype == torch.bfloat16 and hd % 16:
        raise ValueError(f"{name}: the bfloat16 kernel takes hd a multiple of 16, "
                         f"got hd={hd}")


def _simt_smem(K, hd, elem_bytes, bwd):
    """A SIMT kernel's shared memory, in bytes, at the least row stride
    (``cta_elems`` and ``make_plan`` in ``csrc/``): per unit the K x HDP
    tiles of q, k, v (and dO), HDP = hd rounded up to 16 bytes, the K x
    (K + 1) P tile and the 4 x K row partials (the backward keeps those in
    its K x (K + 1) dS tile), squares rounded up to 16 bytes; two units a
    CTA at K <= 16."""
    w = 16 // elem_bytes
    hdp = -(-hd // w) * w
    square = -(-K * (K + 1) // w) * w
    per_cta = 2 if K <= 16 else 1
    unit = (4 * K * hdp + square + max(square, 4 * K)) if bwd else (3 * K * hdp + square + 4 * K)
    return per_cta * unit * elem_bytes


def _check_shapes(name, K, H, hd, *tensors, tiles):
    """Validate the tensors of a kernel; ``tiles(elem_bytes)`` is the SIMT
    kernel's least shared memory in bytes."""
    q2 = tensors[0]
    if q2.dim() != 2 or q2.shape[1] != H * hd or q2.shape[0] % K \
            or any(t.shape != q2.shape for t in tensors):
        raise ValueError(
            f"{name}: tensors must be (R, H*hd) with R % K == 0; "
            f"got {tuple(q2.shape)}, K={K}, H={H}, hd={hd}")
    _shape_rule(name, K, hd, q2.dtype)
    cuda_lib.require_cuda(name, *tensors, dtypes=_DTYPES)
    if any(t.dtype != q2.dtype for t in tensors):
        raise TypeError(f"{name}: all tensors must share a dtype")
    if q2.dtype == torch.bfloat16:
        if any(t.data_ptr() % 16 for t in tensors):
            raise ValueError(f"{name}: the bfloat16 kernel needs 16-byte aligned tensors")
        return
    smem = tiles(8 if q2.dtype == torch.float64 else 4)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: K={K}, hd={hd} in {q2.dtype} needs {smem} bytes of "
                         f"shared memory, above the {_SMEM_LIMIT} a block may have")


@cuda_lib.on_tensor_device
def neighbor_attention_flat_cuda(q2, k2, v2, K, H, hd):
    """The forward kernel.  bfloat16: ``neighbor_attention_mma.cu``, one
    warp per (centre, head) at a time on ``mma.sync`` (launches counted as
    ``neighbor_attention_bf16``).  float32 / float64: the SIMT kernel of
    ``neighbor_attention.cu``, a CTA of four warps per (centre, head),
    lane i holding query row i's scores in registers against broadcast
    loads of k and v,
    every sum in the input type (counted as ``neighbor_attention``): TF32
    tensor cores would break the float32 frame's index-for-index match
    with the CPU."""
    _check_shapes("neighbor_attention_flat", K, H, hd, q2, k2, v2,
                  tiles=lambda b: _simt_smem(K, hd, b, False))
    R = q2.shape[0]
    out = torch.empty_like(q2)
    if R == 0:
        return out
    lib = cuda_lib.lib()
    ptrs = [cuda_lib.ptr(t) for t in (q2, k2, v2, out)]
    stream = cuda_lib.stream_handle(q2.device)
    if q2.dtype == torch.bfloat16:
        name = "neighbor_attention_bf16"
        code = lib.pdanet_neighbor_attention_bf16(*ptrs, R, K, H, hd, stream)
    else:
        name = "neighbor_attention"
        code = lib.pdanet_neighbor_attention(*ptrs, R, K, H, hd, _SIMT_CODES[q2.dtype], stream)
    cuda_lib.check(code, name)
    cuda_lib.launches[name] += 1
    return out


@cuda_lib.on_tensor_device
def neighbor_attention_flat_bwd_cuda(q2, k2, v2, do2, K, H, hd):
    """The backward kernel: softmax recomputed, each (centre, head) owning
    its rows of dq, dk and dv (no atomics).  bfloat16:
    ``neighbor_attention_bwd_mma.cu`` on ``mma.sync`` (counted as
    ``neighbor_attention_bwd_bf16``); float32 / float64: the SIMT kernel of
    ``neighbor_attention_bwd.cu``, a CTA of four warps per (centre, head),
    a row phase (lane i: S, dP, P and dS of row i in registers, then dQ)
    and a column phase (lane j: dK and dV of row j), counted as
    ``neighbor_attention_bwd``."""
    _check_shapes("neighbor_attention_flat_bwd", K, H, hd, q2, k2, v2, do2,
                  tiles=lambda b: _simt_smem(K, hd, b, True))
    R = q2.shape[0]
    dq, dk, dv = (torch.empty_like(q2) for _ in range(3))
    if R == 0:
        return dq, dk, dv
    lib = cuda_lib.lib()
    ptrs = [cuda_lib.ptr(t) for t in (q2, k2, v2, do2, dq, dk, dv)]
    stream = cuda_lib.stream_handle(q2.device)
    if q2.dtype == torch.bfloat16:
        name = "neighbor_attention_bwd_bf16"
        code = lib.pdanet_neighbor_attention_bwd_bf16(*ptrs, R, K, H, hd, stream)
    else:
        name = "neighbor_attention_bwd"
        code = lib.pdanet_neighbor_attention_bwd(*ptrs, R, K, H, hd, _SIMT_CODES[q2.dtype],
                                                 stream)
    cuda_lib.check(code, name)
    cuda_lib.launches[name] += 1
    return dq, dk, dv


@torch.library.custom_op(f"{cuda_lib.NAMESPACE}::neighbor_attention", mutates_args=(),
                         device_types="cpu")
def attention_op(q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor, K: int, H: int,
                 hd: int) -> torch.Tensor:
    return neighbor_attention_flat_plain(q2, k2, v2, K, H, hd)


attention_op.register_kernel("cuda")(neighbor_attention_flat_cuda)


@attention_op.register_fake
def _(q2, k2, v2, K, H, hd):
    return torch.empty_like(q2)


@torch.library.custom_op(f"{cuda_lib.NAMESPACE}::neighbor_attention_bwd", mutates_args=(),
                         device_types="cpu")
def attention_bwd_op(q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor,
                     do2: torch.Tensor, K: int, H: int, hd: int) -> list[torch.Tensor]:
    return list(neighbor_attention_flat_bwd_plain(q2, k2, v2, do2, K, H, hd))


@attention_bwd_op.register_kernel("cuda")
def _(q2, k2, v2, do2, K, H, hd):
    return list(neighbor_attention_flat_bwd_cuda(q2, k2, v2, do2, K, H, hd))


@attention_bwd_op.register_fake
def _(q2, k2, v2, do2, K, H, hd):
    return [torch.empty_like(q2) for _ in range(3)]


def _setup_context(ctx, inputs, output):
    q2, k2, v2, K, H, hd = inputs
    ctx.save_for_backward(q2, k2, v2)
    ctx.shape = (K, H, hd)


def _backward(ctx, do2):
    q2, k2, v2 = ctx.saved_tensors
    dq, dk, dv = attention_bwd_op(q2, k2, v2, do2.to(q2.dtype).contiguous(), *ctx.shape)
    return dq, dk, dv, None, None, None


attention_op.register_autograd(_backward, setup_context=_setup_context)
