"""pdanet_tpu_torch neighbour attention against the JAX package, on the CPU.

The port's plain attention (the CPU path of ``neighbor_attention_flat``) is
held against the Pallas kernel run in interpret mode on the flat
(R, H*hd) layout, atol 1e-5 in float32 (the Pallas kernel's own oracle
tolerance) and 5e-2 in bfloat16.  The PDA transformer layer that holds the
kernel is held against the flax layer with the same weights, carried
across by the weight bridge.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu.models.blocks import TransformerEncoderLayerPreNorm as JLayer
from pdanet_tpu.ops.pallas.attention import neighbor_attention_flat as j_attn
from pdanet_tpu_torch.models.blocks import TransformerEncoderLayerPreNorm
from pdanet_tpu_torch.ops.attention import neighbor_attention_flat
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables


def _qkv(seed, R, D):
    rs = np.random.RandomState(seed)
    return [rs.randn(R, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("centres,K,H,hd", [
    (8, 16, 4, 32),
    (4, 16, 4, 128),
    (4, 32, 4, 64),   # SA1 geometry
])
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
