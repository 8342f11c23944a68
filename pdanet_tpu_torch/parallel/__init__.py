"""Data parallelism over ``torch.distributed``: one process per device, each
with its share of one global batch.

Counterpart of ``pdanet_tpu/parallel/__init__.py``.  The JAX package's
data parallelism is GSPMD over one global batch, so everything that
reduces over the batch reduces over the global batch.  Here each process
runs the model on its own frames, and the reductions over the batch become
explicit collectives:

- BatchNorm's training moments (``models/blocks.py``): the sums of
  :func:`all_reduce_sum`, which is differentiable, so that the backward
  carries the cross-rank terms of the global mean and variance;
- the loss's counts and normalizers (``models/dense_heads/iassd_head.py``):
  :func:`all_reduce_detached` and :func:`share`.  Each rank's loss is then
  its share of the global loss, its own numerator over the global
  denominator: the global loss is the sum of the shares, and its gradient
  the SUM of the ranks' gradients (:func:`reduce_gradients`).

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used, which NCCL
and Gloo both take (Gloo on CUDA tensors too, so two ranks may share one
card).  Without a process group every helper is the identity and no
collective runs; under a launcher they run at world 1 as well.
"""

import torch
import torch.distributed as dist


def is_dist():
    """True in a process of an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if is_dist() else 0


def world():
    return dist.get_world_size() if is_dist() else 1


def barrier():
    if is_dist():
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; its backward is the sum over ranks of the
    output's gradient (every rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t):
    """``t`` summed over the ranks, differentiable; ``t`` in one process."""
    if not is_dist():
        return t
    return _AllReduceSum.apply(t.contiguous())


def all_reduce_detached(t):
    """``t`` summed over the ranks, with no gradient: for counts and
    normalizers.  ``t`` itself in one process."""
    if not is_dist():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def share(n, like):
    """``n`` over its sum across the ranks: the factor that turns a mean
    over this rank's ``n`` elements into its share of the mean over the
    global batch, as a 0-d tensor of ``like``'s device and (float32 at
    least) type.  1.0 in one process, so that a product with it is exact."""
    if not is_dist():
        return 1.0
    dtype = torch.promote_types(like.dtype, torch.float32)
    # a fill, not a copy from the host, which would wait for the device
    return n / all_reduce_detached(torch.full((), float(n), dtype=dtype, device=like.device))


def reduce_gradients(params):
    """Sum each parameter's gradient over the ranks: one ``all_reduce`` a
    (dtype, device) over the gradients flattened into one buffer.  A
    missing gradient counts as zeros (the optimizers read it so) and is
    set to the reduced buffer's slice, as the others are."""
    if not is_dist():
        return
    groups = {}
    for p in params:
        groups.setdefault((p.dtype, p.device), []).append(p)
    for ps in groups.values():
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in ps])
        dist.all_reduce(flat)
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad = g.view_as(p)


def broadcast_module(module, src=0):
    """Give every rank ``src``'s parameters and buffers."""
    if not is_dist():
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src)
