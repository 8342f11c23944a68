"""Shared neural blocks (channels-last), for training and inference.

Counterparts of ``pdanet_tpu/models/blocks.py``,
``pdanet_tpu/models/norm.py`` and flax's ``Conv`` / ``ConvTranspose`` on
channels-last maps.  Attribute names follow the flax module and
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

from .. import parallel
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
    """BatchNorm over the trailing channel axis with the JAX package's torch
    running-statistics semantics (``models/norm.py``).  ``eps`` and
    ``momentum`` are flax's ``epsilon`` and ``momentum``: the IASSD blocks
    keep the defaults 1e-5 and 0.9, PointPillar's VFE and BEV backbone
    take 1e-3 and 0.99 (torch momentum 0.01).

    In training mode the statistics come over every leading axis (for a
    (B, M, K, C) input: B, M and K; for a (B, H, W, C) map: B, H and W,
    empty cells included).  The variance is two-pass and biased
    for normalizing, ``mean((x - mean)^2)``; ``running_var`` takes the
    unbiased ``var * n / (n - 1)``, n the number of reduced elements.  The
    running statistics move by ``momentum * old + (1 - momentum) * new``,
    in place and outside autograd.  At eval the running statistics
    normalize.  Both compute in float32 (float64 for float64 input):
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``.

    In a process group (``parallel.is_dist()``) the training moments are
    those of the global batch, as under the JAX package's GSPMD data
    parallelism: the mean is the all-reduced sum over the all-reduced n,
    the variance the all-reduced sum of squares about that mean over n,
    both sums differentiable, so that the backward carries the other
    ranks' terms; every rank's running statistics stay the same.
    """

    def __init__(self, channels, eps=1e-5, momentum=BN_MOMENTUM, dtype=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
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
            n = xc.numel() // xc.shape[-1]
            if parallel.is_dist():
                total = parallel.all_reduce_sum(
                    torch.cat([xc.sum(dim=dims), xc.new_full((1,), float(n))]))
                n = total[-1].detach()
                mean = total[:-1] / n
                centred = xc - mean
                var = parallel.all_reduce_sum((centred * centred).sum(dim=dims)) / n
                bessel = n / (n - 1).clamp(min=1)
            else:
                mean = xc.mean(dim=dims)
                centred = xc - mean
                var = (centred * centred).mean(dim=dims)
                bessel = n / max(n - 1, 1)
            with torch.no_grad():
                unbiased = var * bessel
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * unbiased)
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


def _same_padding(size, k, s, d=1):
    """flax's 'SAME' padding of one axis: (before, after), the odd unit
    after; ``d`` the kernel's dilation."""
    total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` over a channels-last (B, H, W, C) map: the kernel
    (kh, kw, in, out) is ``weight`` (out, in, kh, kw).  ``padding`` is
    flax's: ``"SAME"`` (XLA's, the odd unit after: a 7 x 7 stride-2 conv
    on an even side pads (2, 3), not torch's symmetric 3) or one (before,
    after) pair for both axes; ``dilation`` flax's ``kernel_dilation``.
    The map reaches ``F.conv2d`` as a permuted view, NCHW in shape and
    channels-last in memory, and comes back the same way, so no copy is
    made on either side.  Computes in the input's and weight's promoted
    dtype."""

    def __init__(self, in_features, features, kernel_size, stride=1, padding="SAME",
                 bias=True, dilation=1):
        super().__init__(in_features, features, kernel_size, stride=stride, bias=bias,
                         dilation=dilation)
        self.flax_padding = padding

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        x = x.to(dt).permute(0, 3, 1, 2)
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        if self.flax_padding == "SAME":
            (t, b), (l, r) = (_same_padding(n, k, s, d) for n in x.shape[2:])
        else:
            (t, b), (l, r) = (self.flax_padding,) * 2
        if t == b and l == r:
            pad = (t, l)
        else:
            x, pad = F.pad(x, (l, r, t, b)), 0
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x, self.weight.to(dt), bias, self.stride, pad, self.dilation)
        return y.permute(0, 2, 3, 1)


class Conv3d(nn.Conv3d):
    """flax ``nn.Conv`` over a 3-D grid, on a (B, C, Z, Y, X) tensor: the
    kernel (kz, ky, kx, in, out) is ``weight`` (out, in, kz, ky, kx);
    ``padding`` is torch's symmetric one a axis (the JAX package's dense
    backbones give it explicitly).  Computes in the input's and weight's
    promoted dtype; the output keeps the input's memory format."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv3d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose`` (``transpose_kernel=False``, 'SAME') over
    a channels-last map, for a kernel as large as its stride (the BEV
    backbone's upsampling): every input cell paints its own s x s patch.
    flax applies the kernel unflipped and ``F.conv_transpose2d`` flipped,
    so ``weight`` (in, out, kh, kw) is the flax kernel (kh, kw, in, out)
    flipped in both spatial axes (``utils/jax_weights.py``)."""

    def __init__(self, in_features, features, kernel_size, stride, bias=True):
        if kernel_size != stride:
            raise NotImplementedError(
                f"ConvTranspose: kernel {kernel_size} != stride {stride} (flax's SAME "
                f"padding then overlaps patches)")
        super().__init__(in_features, features, kernel_size, stride=stride, bias=bias)

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), bias,
                               self.stride)
        return y.permute(0, 2, 3, 1)


class ConvTranspose3d(nn.ConvTranspose3d):
    """flax ``nn.ConvTranspose`` (``transpose_kernel=False``) over a 3-D
    grid with explicit (lo, hi) padding a axis, on a (B, C, Z, Y, X)
    tensor: flax convolves the stride-dilated input, padded (lo, hi), with
    the kernel unflipped, which is ``F.conv_transpose3d`` with the kernel
    flipped, ``padding`` k - 1 - lo and ``output_padding`` hi - lo.  So
    ``weight`` (in, out, kz, ky, kx) is the flax kernel (kz, ky, kx, in,
    out) flipped in the three spatial axes (``utils/jax_weights.py``)."""

    def __init__(self, in_features, features, kernel_size, stride, padding, bias=False):
        kernel_size = tuple(int(k) for k in kernel_size)
        pad = tuple(k - 1 - int(lo) for k, (lo, _) in zip(kernel_size, padding))
        extra = tuple(int(hi) - int(lo) for lo, hi in padding)
        super().__init__(in_features, features, kernel_size, stride=stride, padding=pad,
                         output_padding=extra, bias=bias)

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose3d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                  self.padding, self.output_padding)


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


class CBAM(nn.Module):
    """Spatial attention of the Proposal_Aware SA ablation
    (``pdanet_tpu/models/blocks.py:214-232``; pointnet2_modules.py:
    1010-1046): the spatial half only, as the reference executes it.  Per
    point, the max and the mean over the channels, a bias-free 2 -> 1
    Dense, a sigmoid that scales the input.  The max's gradient is shared
    by tied channels (``amax``), as JAX's ``max`` shares it."""

    def __init__(self):
        super().__init__()
        self.conv_layer = Dense(2, 1, bias=False)

    def forward(self, x):
        mp = torch.amax(x, dim=-1, keepdim=True)
        ap = x.mean(dim=-1, keepdim=True)
        return x * torch.sigmoid(self.conv_layer(torch.cat([mp, ap], dim=-1)))


class EncoderLayer(nn.Module):
    """The FullAttention encoder-layer ablation as the K-neighbour fuser
    (``pdanet_tpu/models/blocks.py:235-278``; pointnet2_modules.py:
    1325-1414): bias-free q / k / v / merge projections, softmax(q k^T /
    sqrt(hd)) v per head, a bias-free d -> 2d -> d feed-forward, and the
    conventional pre-norm residual (the un-normalized input is the
    residual base).  The attention core is the kernel of
    ``ops/attention.py`` on the flat (rows, H*hd) layout, forward and
    backward."""

    def __init__(self, d_model, nhead, dtype=None):
        super().__init__()
        self.nhead = nhead
        self.compute_dtype = dtype
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        for name in ("q_proj", "k_proj", "v_proj", "merge"):
            self.add_module(name, Dense(d_model, d_model, bias=False, dtype=dtype))
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.mlp_0 = Dense(d_model, 2 * d_model, bias=False, dtype=dtype)
        self.mlp_1 = Dense(2 * d_model, d_model, bias=False, dtype=dtype)

    def forward(self, x):
        *batch, K, D = x.shape
        H = self.nhead
        h = self.norm1(x).reshape(-1, D)
        q, k, v = (getattr(self, n)(h) for n in ("q_proj", "k_proj", "v_proj"))
        att = neighbor_attention_flat(q, k, v, K, H, D // H)
        message = self.merge(att).reshape(*batch, K, D) + x
        return message + self.mlp_1(torch.relu(self.mlp_0(self.norm2(message))))


@torch.no_grad()
def init_random_weights(model, seed):
    """Seeded random weights in the flax initializers' spirit: Dense and
    convolution kernels lecun-normal, biases zero (a conv's ``bias_init``
    where it has one: CenterPoint's heatmap output, -2.19); BatchNorm running
    statistics drawn around (0, 1) so that eval-mode normalization is not
    the identity.  A parameter kept in flax's layout under its flax name
    (the sparse conv kernels, (K, C_in, C_out)) is lecun-normal over its
    fan-in K * C_in."""
    g = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, (Dense, Conv, Conv3d, ConvTranspose, ConvTranspose3d)):
            w = torch.randn(mod.weight.shape, generator=g)
            fan_in = (mod.in_features if isinstance(mod, Dense)
                      else mod.in_channels * math.prod(mod.kernel_size))
            mod.weight.copy_(w / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.fill_(getattr(mod, "bias_init", 0.0))
        elif isinstance(mod, BatchNorm):
            c = mod.weight.shape[0]
            mod.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=g))
            mod.bias.copy_(0.1 * torch.randn(c, generator=g))
            mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            mod.running_var.copy_(0.5 + torch.rand(c, generator=g))
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        if not name.endswith((".weight", ".bias")):
            w = torch.randn(p.shape, generator=g)
            p.copy_(w / math.sqrt(math.prod(p.shape[:-1])))
    return model
