"""Shared neural blocks (channels-last), for training and inference.

Counterparts of ``pdanet_tpu/models/blocks.py`` and
``pdanet_tpu/models/norm.py``.  Attribute names follow the flax module and
parameter names (``layer0.dense``, ``bn``, ``self_attn.query`` ...), so a
JAX variable tree maps onto the state_dict mechanically
(``utils/jax_weights.py``).  ``Module.training`` is the JAX package's
``train`` flag: BatchNorm normalizes with batch statistics and updates its
running statistics in training mode.

Compute dtype (``blocks.py:29-71`` of the JAX package): a block's
``dtype`` is None (the inputs' and parameters' promoted type throughout),
a plain dtype (bfloat16 at eval only, the yaml's ``COMPUTE_DTYPE``; training
then runs float32), or :class:`TrainEvalDtype` (the yaml's
``TRAIN_COMPUTE_DTYPE``: bfloat16 at eval and in training).  Linear layers
run in the compute dtype with the float32 parameters cast.  BatchNorm and
LayerNorm compute in float32; at eval they return the compute dtype, and
under bfloat16 training they return float32, as flax promotes there.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import neighbor_attention_flat

BN_MOMENTUM = 0.9  # flax convention: running = 0.9 * running + 0.1 * batch


@dataclass(frozen=True)
class TrainEvalDtype:
    """Apply ``dtype`` in training too (bfloat16 train compute); params,
    optimizer state and normalization statistics stay float32."""

    dtype: torch.dtype


def infer_dtype(dtype, training):
    """The compute dtype of a Linear layer (``blocks._infer_dtype``): a
    plain dtype applies at eval only, ``TrainEvalDtype`` always."""
    if isinstance(dtype, TrainEvalDtype):
        return dtype.dtype
    return None if training else dtype


def norm_dtype(dtype, training):
    """The output dtype of a norm layer (``blocks._norm_dtype``): None
    (promoted, float32) under bfloat16 training, else as Linear layers."""
    if training and isinstance(dtype, TrainEvalDtype):
        return None
    return infer_dtype(dtype, training)


class Dense(nn.Linear):
    """flax ``nn.Dense``: kernel (in, out) is ``weight`` (out, in)."""

    def __init__(self, in_features, out_features, bias=True, dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = (infer_dtype(self.compute_dtype, self.training)
              or torch.promote_types(x.dtype, self.weight.dtype))
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis, eps 1e-5, with the JAX
    package's torch running-statistics semantics (``models/norm.py``).

    In training mode the statistics come over every leading axis (for a
    (B, M, K, C) input: B, M and K).  The variance is two-pass and biased
    for normalizing, ``mean((x - mean)^2)``; ``running_var`` takes the
    unbiased ``var * n / (n - 1)``, n the number of reduced elements.  The
    running statistics move by ``0.9 * old + 0.1 * new`` (flax momentum
    0.9), in place and outside autograd.  At eval the running statistics
    normalize.  Both compute in float32 (float64 for float64 input):
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``.
    """

    def __init__(self, channels, eps=1e-5, dtype=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        ct = torch.promote_types(x.dtype, self.weight.dtype)
        xc = x.to(ct)
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xc.mean(dim=dims)
            centred = xc - mean
            var = (centred * centred).mean(dim=dims)
            n = xc.numel() // xc.shape[-1]
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * unbiased)
        else:
            centred = xc - self.running_mean
            var = self.running_var
        y = centred * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(norm_dtype(self.compute_dtype, self.training) or ct)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing axis, eps 1e-5, computed in float32
    (float64 for float64 input) by ``F.layer_norm``, whose variance does
    not cancel as ``E[x^2] - E[x]^2`` does (the JAX package asks flax for
    the two-pass form for that reason), and returned in the norm dtype of
    ``dtype`` (or the promoted type)."""

    def __init__(self, channels, eps=1e-5, dtype=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        ct = torch.promote_types(x.dtype, self.weight.dtype)
        y = F.layer_norm(x.to(ct), self.weight.shape, self.weight, self.bias,
                         self.eps)
        return y.to(norm_dtype(self.compute_dtype, self.training) or ct)


class DenseBNReLU(nn.Module):
    """Dense -> BatchNorm -> ReLU over the trailing axis (a 1x1 conv)."""

    def __init__(self, in_features, features, use_bias=False, dtype=None):
        super().__init__()
        self.dense = Dense(in_features, features, bias=use_bias, dtype=dtype)
        self.bn = BatchNorm(features, dtype=dtype)

    def forward(self, x):
        return torch.relu(self.bn(self.dense(x)))


class MLPStack(nn.Module):
    """A stack of Dense+BN+ReLU layers named ``layer{i}``."""

    def __init__(self, in_features, features, dtype=None):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"layer{i}", DenseBNReLU(in_features, f, dtype=dtype))
            in_features = f

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x)
        return x


class DensityNet(nn.Module):
    """MLP(1->16->8->1) over group densities; every layer is BN + ReLU,
    as the reference executes it (no sigmoid)."""

    def __init__(self, hidden=(16, 8)):
        super().__init__()
        widths = tuple(hidden) + (1,)
        self.n = len(widths)
        cin = 1
        for i, f in enumerate(widths):
            self.add_module(f"conv{i}", Dense(cin, f, bias=True))
            self.add_module(f"bn{i}", BatchNorm(f))
            cin = f

    def forward(self, x):
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class NeighborMHA(nn.Module):
    """Self-attention over the K neighbours of each centre, with the
    parameter layout of flax ``MultiHeadDotProductAttention``.

    The q/k/v projections and the out projection are plain 2-D products on
    the flat (rows, H*hd) layout; the attention core between them is the
    kernel of ``ops/attention.py``.
    """

    def __init__(self, d_model, num_heads, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(d_model, d_model, bias=True, dtype=dtype))

    def forward(self, x):
        B, M, K, D = x.shape
        H = self.num_heads
        dt = infer_dtype(self.compute_dtype, self.training) or x.dtype
        x2 = x.reshape(-1, D).to(dt)
        q, k, v = (getattr(self, n)(x2) for n in ("query", "key", "value"))
        core = neighbor_attention_flat(q, k, v, K, H, D // H)
        return self.out(core).reshape(B, M, K, D)


class TransformerEncoderLayerPreNorm(nn.Module):
    """Pre-norm self-attention over the K neighbours of each centre
    (``pdanet_tpu/models/blocks.py:281-384``).

    The reference's quirk is kept: the residual is added to the
    *normalized* input, ``src = norm1(src); src = src + attn(src)``.
    """

    def __init__(self, d_model, nhead, dim_feedforward, dtype=None):
        super().__init__()
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.self_attn = NeighborMHA(d_model, nhead, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype=dtype)

    def forward(self, x):
        x = self.norm1(x)
        x = x + self.self_attn(x)
        x = self.norm2(x)
        return x + self.linear2(torch.relu(self.linear1(x)))


@torch.no_grad()
def init_random_weights(model, seed):
    """Seeded random weights in the flax initializers' spirit: Dense
    kernels lecun-normal, biases zero; BatchNorm running statistics drawn
    around (0, 1) so that eval-mode normalization is not the identity."""
    g = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, Dense):
            w = torch.randn(mod.weight.shape, generator=g)
            mod.weight.copy_(w / math.sqrt(mod.in_features))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            c = mod.weight.shape[0]
            mod.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=g))
            mod.bias.copy_(0.1 * torch.randn(c, generator=g))
            mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            mod.running_var.copy_(0.5 + torch.rand(c, generator=g))
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model
