"""pdanet_tpu_torch neighbour attention against the JAX package, on the CPU.

The port's plain attention (the CPU path of ``neighbor_attention_flat``) is
held against the Pallas kernel run in interpret mode on the flat
(R, H*hd) layout, atol 1e-5 in float32 (the Pallas kernel's own oracle
tolerance) and 5e-2 in bfloat16.  Its plain backward is held against
``jax.vjp`` of the Pallas kernel's custom VJP, also in interpret mode: atol
1e-5 in float32, 5e-2 of the largest |gradient| in bfloat16 (the Pallas
backward rounds P and dS to bfloat16 between its products, the plain one
does not).  ``torch.autograd.gradcheck`` holds the attention op's CPU
path and its gradient (``register_autograd``) against finite differences
in float64.  ``scaled_dot_product_attention``
on the (centres, H, K, hd) view of the flat tensors -- the library call the
chip check times beside the kernels -- is held against the plain forward and
backward in float32 (atol 1e-5), so that the yardstick computes the
kernels' function.  The bfloat16 kernels' shape rule is checked without a
card.  The PDA transformer layer
that holds the kernel is held against the flax layer with the same
weights, carried across by the weight bridge: its output at eval, and its
parameter gradients in training mode against ``jax.grad`` of the flax
layer with the Pallas core (interpret mode), atol 1e-4 relative to each
leaf's largest |gradient|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu.models.blocks import TransformerEncoderLayerPreNorm as JLayer
from pdanet_tpu.ops.pallas.attention import neighbor_attention_flat as j_attn
from pdanet_tpu.ops.pallas.attention import (
    neighbor_attention_flat_trainable as j_attn_trainable,
)
from pdanet_tpu_torch.models.blocks import TransformerEncoderLayerPreNorm
from pdanet_tpu_torch.ops.attention import (
    _check_shapes,
    attention_op,
    _shape_rule,
    neighbor_attention_flat,
    neighbor_attention_flat_bwd_plain,
    neighbor_attention_flat_plain,
)
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _qkv(seed, R, D):
    rs = np.random.RandomState(seed)
    return [rs.randn(R, D).astype(np.float32) for _ in range(3)]


SHAPES = [
    (8, 16, 4, 32),
    (4, 16, 4, 128),
    (4, 32, 4, 64),   # SA1 geometry
]


@pytest.mark.parametrize("centres,K,H,hd", SHAPES)
def test_plain_matches_pallas_interpret(centres, K, H, hd):
    q, k, v = _qkv(K * hd, centres * K, H * hd)
    want = np.asarray(j_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             K=K, H=H, hd=hd, interpret=True))
    got = neighbor_attention_flat(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), K, H, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_plain_bf16_matches_pallas_interpret():
    K, H, hd = 16, 4, 32
    q, k, v = _qkv(1, 8 * K, H * hd)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(j_attn(*jb, K=K, H=H, hd=hd, interpret=True), np.float32)
    tb = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in jb]
    got = neighbor_attention_flat(*tb, K, H, hd)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2)


@pytest.mark.parametrize("impl", ["flax", "pallas_interpret"])
def test_transformer_layer_matches_flax(impl):
    B, M, K, D, ff = 1, 6, 16, 128, 64
    rs = np.random.RandomState(5)
    x = rs.randn(B, M, K, D).astype(np.float32)
    layer = JLayer(d_model=D, nhead=4, dim_feedforward=ff, attention_impl=impl)
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    # non-trivial norms and biases
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rs.randn(*a.shape).astype(np.float32),
        jax.device_get(variables))
    want = np.asarray(layer.apply(variables, jnp.asarray(x), train=False))
    port = TransformerEncoderLayerPreNorm(D, 4, ff).eval()
    load_jax_variables(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def _jax_vjp(q, k, v, do, K, H, hd):
    _, vjp = jax.vjp(lambda a, b, c: j_attn_trainable(a, b, c, K, H, hd, True),
                     q, k, v)
    return vjp(do)


@pytest.mark.parametrize("centres,K,H,hd", SHAPES)
def test_plain_backward_matches_pallas_vjp(centres, K, H, hd):
    q, k, v, do = (np.random.RandomState(K + hd + i).randn(centres * K, H * hd)
                   .astype(np.float32) for i in range(4))
    want = _jax_vjp(*(jnp.asarray(a) for a in (q, k, v, do)), K, H, hd)
    got = neighbor_attention_flat_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)), K, H, hd)
    for name, g, w in zip("qkv", got, want):
        err = np.abs(g.numpy() - np.asarray(w)).max()
        assert err <= 1e-5, f"d{name}: max abs err {err:.3g} > 1e-5"


def test_plain_backward_bf16_matches_pallas_vjp():
    K, H, hd = 16, 4, 32
    arrs = [jnp.asarray(np.random.RandomState(i).randn(8 * K, H * hd), jnp.bfloat16)
            for i in range(4)]
    want = _jax_vjp(*arrs, K, H, hd)
    got = neighbor_attention_flat_bwd_plain(
        *(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in arrs),
        K, H, hd)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        rel = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert rel <= 5e-2, f"d{name}: max err {rel:.3g} of max |grad| > 5e-2"


def test_function_gradcheck_float64():
    K, H, hd = 8, 2, 16
    rs = np.random.RandomState(4)
    q, k, v = (torch.tensor(rs.randn(3 * K, H * hd), dtype=torch.float64,
                            requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: attention_op(a, b, c, K, H, hd), (q, k, v))
    out = neighbor_attention_flat(q, k, v, K, H, hd)
    assert out.dtype == torch.float64 and out.grad_fn is not None


def test_transformer_layer_grads_match_flax_train():
    B, M, K, D, ff = 1, 4, 16, 128, 64
    rs = np.random.RandomState(6)
    x = rs.randn(B, M, K, D).astype(np.float32)
    layer = JLayer(d_model=D, nhead=4, dim_feedforward=ff,
                   attention_impl="pallas_interpret")
    variables = layer.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rs.randn(*a.shape).astype(np.float32),
        jax.device_get(variables))
    w = rs.randn(B, M, K, D).astype(np.float32)  # a loss that weighs every output

    def loss_fn(params):
        y = layer.apply({"params": params}, jnp.asarray(x), train=True)
        return jnp.sum(y * w)

    want = jax.device_get(jax.grad(loss_fn)(variables["params"]))
    port = TransformerEncoderLayerPreNorm(D, 4, ff).train()
    load_jax_variables(port, variables)
    (port(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    ref = TransformerEncoderLayerPreNorm(D, 4, ff)
    load_jax_variables(ref, {"params": want})  # the flax grads, in port layout
    want = {k: v.numpy() for k, v in ref.state_dict().items()}
    # the key bias has a zero true gradient (softmax ignores a shift of
    # every score of a row): its leaf scale is the layer's
    floor = 1e-3 * max(np.abs(g).max() for g in want.values())
    for name, p in port.named_parameters():
        err = np.abs(p.grad.numpy() - want[name]).max()
        scale = max(np.abs(want[name]).max(), floor)
        assert err <= 1e-4 * scale, f"{name}: grad err {err:.3g}, scale {scale:.3g}"


def test_cpu_autograd_takes_the_plain_versions():
    """On CPU tensors the op and its gradient run the plain forward and
    backward and never the kernel library; the backward kernel's wrapper
    refuses a CPU tensor instead of falling back."""
    from pdanet_tpu_torch.ops import cuda_lib
    from pdanet_tpu_torch.ops.attention import neighbor_attention_flat_bwd_cuda

    cuda_lib.launches.clear()
    K, H, hd = 8, 2, 16
    q, k, v = (torch.randn(2 * K, H * hd, requires_grad=True) for _ in range(3))
    neighbor_attention_flat(q, k, v, K, H, hd).sum().backward()
    assert q.grad is not None and sum(cuda_lib.launches.values()) == 0
    with pytest.raises(ValueError):
        neighbor_attention_flat_bwd_cuda(q.detach(), k.detach(), v.detach(),
                                         q.detach(), K, H, hd)


def _sdpa_heads(t, K, H, hd):  # (R, H*hd) -> (centres, H, K, hd), a view
    return t.view(t.shape[0] // K, K, H, hd).transpose(1, 2)


SDPA_SHAPES = [(K, hd) for K in (16, 32) for hd in (64, 128)]  # SA1 / SA2 geometry


@pytest.mark.parametrize("K,hd", SDPA_SHAPES)
def test_sdpa_matches_plain_forward(K, hd):
    H = 4
    q, k, v = (torch.from_numpy(a) for a in _qkv(K + hd, 6 * K, H * hd))
    got = torch.nn.functional.scaled_dot_product_attention(
        *(_sdpa_heads(t, K, H, hd) for t in (q, k, v)))
    want = neighbor_attention_flat_plain(q, k, v, K, H, hd)
    err = (got.transpose(1, 2).reshape(q.shape) - want).abs().max().item()
    assert err <= 1e-5, f"SDPA against the plain forward: max abs err {err:.3g}"


@pytest.mark.parametrize("K,hd", SDPA_SHAPES)
def test_sdpa_grads_match_plain_backward(K, hd):
    H = 4
    rs = np.random.RandomState(K * hd)
    q, k, v, do = (torch.from_numpy(rs.randn(6 * K, H * hd).astype(np.float32))
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *(_sdpa_heads(t, K, H, hd) for t in leaves))
    got = torch.autograd.grad(out, leaves, _sdpa_heads(do, K, H, hd))
    want = neighbor_attention_flat_bwd_plain(q, k, v, do, K, H, hd)
    for name, g, w in zip("qkv", got, want):
        err = (g - w).abs().max().item()
        assert err <= 1e-5, f"SDPA d{name} against the plain backward: max abs err {err:.3g}"


@pytest.mark.parametrize("K,hd", [(65, 64), (32, 24)])
def test_bf16_kernel_shape_rule_refuses(K, hd):
    """K above 64 or hd not a multiple of 16 raise ValueError before any
    device check, so a CUDA tensor of such a shape never reaches a kernel."""
    with pytest.raises(ValueError, match="K <= 64|multiple of 16"):
        _shape_rule("neighbor_attention_flat", K, hd, torch.bfloat16)
    q = torch.zeros(2 * K, 4 * hd, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K <= 64|multiple of 16"):
        _check_shapes("neighbor_attention_flat", K, 4, hd, q, q, q, tiles=lambda b: 0)


@pytest.mark.parametrize("K,hd", [(K, hd) for K in (8, 16, 32, 64) for hd in (32, 64, 128)])
def test_bf16_kernel_shape_rule_takes(K, hd):
    _shape_rule("neighbor_attention_flat", K, hd, torch.bfloat16)
    # float32 (the SIMT kernel) takes any hd up to 128
    _shape_rule("neighbor_attention_flat", K, hd - 8, torch.float32)
