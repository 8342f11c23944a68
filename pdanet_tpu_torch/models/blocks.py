"""Shared neural blocks (channels-last, inference).

Counterparts of ``pdanet_tpu/models/blocks.py``.  Attribute names follow
the flax module and parameter names (``layer0.dense``, ``bn``,
``self_attn.query`` ...), so a JAX variable tree maps onto the state_dict
mechanically (``utils/jax_weights.py``).

Compute dtype: a block given ``dtype`` (bfloat16 at eval under the
yaml's ``COMPUTE_DTYPE``) runs its Linear layers in that dtype with the
float32 parameters cast; BatchNorm and LayerNorm compute in float32 and
return that dtype, as the flax modules do at eval.  ``dtype=None`` is
float32 throughout.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import neighbor_attention_flat


class Dense(nn.Linear):
    """flax ``nn.Dense``: kernel (in, out) is ``weight`` (out, in)."""

    def __init__(self, in_features, out_features, bias=True, dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the trailing channel axis, eps 1e-5:
    ``(x - mean) * rsqrt(var + eps) * weight + bias``."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "pdanet_tpu_torch runs inference only; training is ROADMAP "
                "queue 1 item 6")
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean) * mul + self.bias).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing axis, eps 1e-5, computed in float32 and
    returned in ``dtype`` (or the input dtype)."""

    def __init__(self, channels, eps=1e-5, dtype=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                         self.eps)
        return y.to(self.compute_dtype or x.dtype)


class DenseBNReLU(nn.Module):
    """Dense -> BatchNorm -> ReLU over the trailing axis (a 1x1 conv)."""

    def __init__(self, in_features, features, use_bias=False, dtype=None):
        super().__init__()
        self.dense = Dense(in_features, features, bias=use_bias, dtype=dtype)
        self.bn = BatchNorm(features)

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
        x2 = x.reshape(-1, D).to(self.compute_dtype or x.dtype)
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
