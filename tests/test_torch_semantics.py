"""Unit oracles for the torch-gradient-semantics ops introduced in round 3
(found by the training-trajectory twin, tests/test_train_trajectory_twin.py):

* ``ops/maxpool.max_first`` — max whose VJP routes the cotangent to the
  FIRST maximal slot, like torch ``F.max_pool2d`` / ``Tensor.max(dim=)``
  (jnp.max splits among ties; ball-query duplicate padding makes exact
  ties ubiquitous).
* ``models/norm.BatchNorm`` — torch running-statistics semantics:
  unbiased (n-1) variance folded into running_var, two-pass batch
  variance, biased variance for normalization.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)

pytestmark = pytest.mark.smoke


class TestMaxFirst:
    def test_forward_equals_jnp_max(self):
        from pdanet_tpu.ops.maxpool import max_first

        rs = np.random.RandomState(0)
        x = jnp.asarray(rs.randn(3, 5, 7).astype(np.float32))
        for ax in (0, 1, 2, -1):
            np.testing.assert_array_equal(
                np.asarray(max_first(x, ax)), np.asarray(jnp.max(x, axis=ax))
            )

    def test_tie_gradient_routes_to_first_slot(self):
        from pdanet_tpu.ops.maxpool import max_first

        x = jnp.asarray(np.array(
            [[1.0, 1.0, 0.5, 1.0],
             [0.2, 0.9, 0.9, 0.1]], np.float32))
        cot = jnp.asarray(np.array([2.0, 3.0], np.float32))
        g = jax.grad(lambda x: jnp.vdot(max_first(x, 1), cot))(x)
        np.testing.assert_array_equal(
            np.asarray(g),
            [[2.0, 0.0, 0.0, 0.0], [0.0, 3.0, 0.0, 0.0]],
        )
        # jnp.max would split: confirm the difference is real
        gs = jax.grad(lambda x: jnp.vdot(jnp.max(x, axis=1), cot))(x)
        assert not np.array_equal(np.asarray(g), np.asarray(gs))

    def test_matches_torch_maxpool_grad(self):
        torch = pytest.importorskip("torch")
        from pdanet_tpu.ops.maxpool import max_first

        rs = np.random.RandomState(1)
        # duplicate-padded groups: values repeat along K like ball-query
        # first-hit padding produces
        x = rs.randn(4, 6, 8).astype(np.float32)
        x[:, :, 3:] = x[:, :, :1]  # slots 3.. duplicate slot 0
        cot = rs.randn(4, 6).astype(np.float32)

        g = jax.grad(
            lambda a: jnp.vdot(max_first(a, 2), jnp.asarray(cot))
        )(jnp.asarray(x))

        t = torch.from_numpy(x).requires_grad_(True)
        pooled = torch.nn.functional.max_pool1d(
            t.reshape(24, 1, 8), 8).reshape(4, 6)
        (pooled * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_array_equal(np.asarray(g), t.grad.numpy())

    def test_grad_through_interior_axis(self):
        from pdanet_tpu.ops.maxpool import max_first, max_first_keepdims

        rs = np.random.RandomState(2)
        x = jnp.asarray(rs.randn(2, 5, 4, 3).astype(np.float32))
        v, g = jax.value_and_grad(
            lambda a: jnp.sum(max_first(a, 2) ** 2))(x)
        assert np.isfinite(float(v)) and np.asarray(g).shape == x.shape
        y = max_first_keepdims(x, 2)
        assert y.shape == (2, 5, 1, 3)


class TestTorchBatchNorm:
    def test_running_stats_match_torch(self):
        torch = pytest.importorskip("torch")
        from pdanet_tpu.models.norm import BatchNorm

        rs = np.random.RandomState(3)
        x1 = rs.randn(6, 9, 5).astype(np.float32)
        x2 = rs.randn(6, 9, 5).astype(np.float32)

        m = BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
        vs = m.init(jax.random.PRNGKey(0), jnp.asarray(x1))
        y1, mut = m.apply(vs, jnp.asarray(x1), mutable=["batch_stats"])
        y2, mut = m.apply({**vs, "batch_stats": mut["batch_stats"]},
                          jnp.asarray(x2), mutable=["batch_stats"])

        tb = torch.nn.BatchNorm1d(5, momentum=0.1).train()
        ty1 = tb(torch.from_numpy(x1.transpose(0, 2, 1)))
        ty2 = tb(torch.from_numpy(x2.transpose(0, 2, 1)))

        np.testing.assert_allclose(
            np.asarray(y2), ty2.detach().numpy().transpose(0, 2, 1),
            rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(mut["batch_stats"]["mean"]),
            tb.running_mean.detach().numpy(), rtol=1e-5, atol=1e-7)
        # the unbiased (n-1) running variance is the semantic under test
        np.testing.assert_allclose(
            np.asarray(mut["batch_stats"]["var"]),
            tb.running_var.detach().numpy(), rtol=1e-5)

    def test_activation_parity_with_stock_flax(self):
        """Guard against flax-internals drift (ADVICE r3): our BatchNorm
        re-implements flax's __call__ via private helpers
        (_canonicalize_axes/_compute_stats/_normalize); if a flax upgrade
        changes their semantics, activations must still match stock
        nn.BatchNorm bit-for-bit (only the RUNNING stats differ)."""
        import flax.linen as nn

        from pdanet_tpu.models.norm import BatchNorm

        rs = np.random.RandomState(7)
        x = jnp.asarray(rs.randn(4, 11, 6).astype(np.float32))

        ours = BatchNorm(use_running_average=False, momentum=0.9,
                         epsilon=1e-5)
        stock = nn.BatchNorm(use_running_average=False, momentum=0.9,
                             epsilon=1e-5, use_fast_variance=False)
        vs = ours.init(jax.random.PRNGKey(0), x)
        y_ours, mut_ours = ours.apply(vs, x, mutable=["batch_stats"])
        y_stock, mut_stock = stock.apply(vs, x, mutable=["batch_stats"])
        # train-mode activations identical (both normalize with the
        # biased two-pass batch variance)
        np.testing.assert_array_equal(np.asarray(y_ours),
                                      np.asarray(y_stock))
        # running stats differ EXACTLY by the Bessel factor n/(n-1):
        # recover the biased batch var from stock's EMA (init var = 1.0)
        n = x.shape[0] * x.shape[1]
        biased_batch_var = (np.asarray(mut_stock["batch_stats"]["var"])
                            - 0.9 * 1.0) / 0.1
        expect_var = 0.9 * 1.0 + 0.1 * biased_batch_var * (n / (n - 1))
        np.testing.assert_allclose(
            np.asarray(mut_ours["batch_stats"]["var"]), expect_var,
            rtol=1e-5)
        # eval-mode: given identical batch_stats, outputs identical
        stats = {"batch_stats": mut_ours["batch_stats"]}
        e_ours = BatchNorm(use_running_average=True, epsilon=1e-5).apply(
            {**vs, **stats}, x)
        e_stock = nn.BatchNorm(use_running_average=True, epsilon=1e-5,
                               use_fast_variance=False).apply(
            {**vs, **stats}, x)
        np.testing.assert_array_equal(np.asarray(e_ours),
                                      np.asarray(e_stock))
