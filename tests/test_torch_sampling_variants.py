"""The sampling methods of the IASSD surface in pdanet_tpu_torch against the
JAX package (``pdanet_tpu/ops/sampling.py``), on the CPU, on seeded numpy
inputs handed to both.  Every index is compared exactly:

* F-FPS (``farthest_point_sample_features``) against JAX's and against
  FPS over the (B, N, N) matrix (``farthest_point_sample_with_dist``), with
  duplicated rows; ``calc_square_dist`` within 2e-5 of JAX's; the F-FPS
  op through ``torch.library.opcheck``;
* FS (F-FPS over ``[xyz | features]``, then D-FPS) through the backbone's
  ``sample_indices``;
* ``ds_fps`` and ``ry_fps``, with duplicated points, points on y = 0
  (+-pi/2, -0.0 among them) and at x = y = 0 (a NaN key, sorted last as
  ``jnp.argsort`` sorts it); N or npoint not divisible by 4 raises;
* the FPS identity shortcut's decision per layer, equal to the JAX
  backbone's, for layouts with a D-FPS layer after an FS, ds_FPS or F-FPS
  layer; and such a backbone's sampled and ball-query indices equal to
  JAX's, layer by layer.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from model_cfg import tiny_model_cfg
from pdanet_tpu.models.backbones_3d import iassd_backbone as j_bb
from pdanet_tpu.ops import sampling as j_s
from pdanet_tpu_torch.models.backbones_3d import iassd_backbone as bb
from pdanet_tpu_torch.ops import sampling as s
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_parta2 import random_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _feats(B, N, C, seed, dups=0):
    f = np.random.RandomState(seed).randn(B, N, C).astype(np.float32)
    if dups:
        f[:, N - dups:] = f[:, :dups]
    return f


@pytest.mark.parametrize("B, N, C, npoint, dups", [(2, 48, 7, 12, 0), (2, 200, 19, 60, 50),
                                                   (1, 97, 3, 97, 0)])
def test_ffps_equals_jax_and_with_dist(B, N, C, npoint, dups):
    f = _feats(B, N, C, N + C, dups)
    got = s.farthest_point_sample_features(torch.from_numpy(f), npoint).numpy()
    want = np.asarray(j_s.farthest_point_sample_features(jnp.asarray(f), npoint))
    np.testing.assert_array_equal(got, want)
    d = np.sum((f[:, :, None] - f[:, None, :]) ** 2, axis=-1).astype(np.float32)
    with_dist = s.farthest_point_sample_with_dist(torch.from_numpy(d), npoint).numpy()
    np.testing.assert_array_equal(with_dist, np.asarray(
        j_s.farthest_point_sample_with_dist(jnp.asarray(d), npoint)))
    np.testing.assert_array_equal(got, with_dist)
    assert got.dtype == np.int32 and (got[:, 0] == 0).all()
    if dups and npoint > N - dups:  # the distinct rows run out: duplicates of picks follow
        assert len(set(got[0].tolist())) == npoint


def test_calc_square_dist_equals_jax():
    a, b = _feats(2, 30, 6, 1), _feats(2, 20, 6, 2)
    got = s.calc_square_dist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(j_s.calc_square_dist(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (2, 30, 20)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_fs_sampling_equals_jax():
    """FS: 2 * npoint indices, the F-FPS picks over [xyz | features] first."""
    f = _feats(2, 128, 11, 5)
    xyz, feats = f[..., :3] * 4.0, f[..., 3:]
    got = bb.sample_indices("FS", 20, torch.from_numpy(xyz), torch.from_numpy(feats), None)
    want = np.asarray(j_bb.sample_indices("FS", 20, jnp.asarray(xyz), jnp.asarray(feats), None))
    assert got.shape == (2, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    for kind in ("F-FPS", "FFS"):
        one = bb.sample_indices(kind, 20, torch.from_numpy(xyz), torch.from_numpy(feats), None)
        np.testing.assert_array_equal(one.numpy(), want[:, :20])


def _sector_cloud(seed, B=2, N=128):
    xyz = (np.random.RandomState(seed).randn(B, N, 3) * 6.0).astype(np.float32)
    xyz[0, 10:14, 1] = 0.0  # atan(x / 0) = +-pi/2
    xyz[0, 14, 1] = -0.0
    xyz[0, 15:17, :2] = 0.0  # atan(0 / 0) = NaN
    xyz[1, 64:96] = xyz[1, 0:32]  # duplicated points
    return xyz


@pytest.mark.parametrize("fn", ["ds_fps", "ry_fps"])
@pytest.mark.parametrize("npoint", [32, 64])
def test_sector_fps_equals_jax(fn, npoint):
    xyz = _sector_cloud(7)
    got = getattr(s, fn)(torch.from_numpy(xyz), npoint).numpy()
    want = np.asarray(getattr(j_s, fn)(jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (2, npoint)
    if fn == "ry_fps":  # the NaN keys sort last: into the last sector's cloud
        with np.errstate(divide="ignore", invalid="ignore"):
            keys = np.arctan(xyz[0, :, 0] / xyz[0, :, 1])
        assert np.isnan(keys).sum() == 2
    method = "ds_FPS" if fn == "ds_fps" else "ry_FPS"
    via = bb.sample_indices(method, npoint, torch.from_numpy(xyz), None, None)
    np.testing.assert_array_equal(via.numpy(), want)


@pytest.mark.parametrize("N, npoint", [(126, 32), (128, 30)])
def test_sector_fps_needs_parts_of_four(N, npoint):
    xyz = _sector_cloud(8, N=N)
    with pytest.raises(ValueError, match="divide by 4"):
        s.ds_fps(torch.from_numpy(xyz), npoint)
    with pytest.raises(TypeError):  # JAX's reshape fails there
        j_s.ds_fps(jnp.asarray(xyz), npoint)


LAYOUTS = {
    # SA0 FS (2 x 32 picks), SA1 D-FPS after it: no shortcut for SA1
    "fs_then_dfps": ([["FS"], ["D-FPS"]], [[32], [16]]),
    "dsfps_then_dfps": ([["ds_FPS"], ["D-FPS"]], [[64], [32]]),
    "dfps_then_ffps": ([["D-FPS"], ["F-FPS"]], [[64], [32]]),
    "dfps_then_dfps": ([["D-FPS"], ["D-FPS"]], [[64], [32]]),
}


def _layout_cfg(name):
    cfg = EasyDict(copy.deepcopy(tiny_model_cfg(3)))
    sa = cfg.BACKBONE_3D.SA_CONFIG
    (m0, m1), (n0, n1) = LAYOUTS[name]
    sa.SAMPLE_METHOD_LIST[0], sa.SAMPLE_METHOD_LIST[1] = m0, m1
    sa.NPOINT_LIST[0], sa.NPOINT_LIST[1] = n0, n1
    return cfg


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_shortcut_decision_and_indices_equal_jax(name):
    """The identity shortcut only after a pure D-FPS layer: each layer's
    decision equal to the JAX backbone's, and the backbone's sampled and
    ball-query indices equal to JAX's on the same weights."""
    cfg = _layout_cfg(name)
    pts = np.concatenate([_sector_cloud(9)[..., :3] * 0.5,
                          np.random.RandomState(4).rand(2, 128, 1).astype(np.float32)], -1)
    jbb = j_bb.IASSDBackbone(model_cfg=cfg.BACKBONE_3D, num_class=3, input_channels=4)
    variables = random_variables(jbb, (jnp.asarray(pts),), 3)
    want_flags = jbb.apply(variables, method=lambda m: m.fps_identity)
    out, inter = jax.jit(lambda v, p: jbb.apply(
        v, p, capture_intermediates=lambda mdl, _: (mdl.name or "").startswith("SA_modules"),
        mutable=["intermediates"]))(variables, jnp.asarray(pts))
    model = bb.IASSDBackbone(cfg.BACKBONE_3D, 3, 4).eval()
    load_jax_variables(model, variables)
    assert model.fps_identity == list(want_flags)
    assert model.fps_identity[1] == (name == "dfps_then_dfps")
    with torch.no_grad():
        got = model(torch.from_numpy(pts))
    sa = cfg.BACKBONE_3D.SA_CONFIG
    for k in range(3):
        want_idx = inter["intermediates"][f"SA_modules_{k}"]["__call__"][0][3]
        if want_idx is not None:
            np.testing.assert_array_equal(got["sampled_idx"][k].numpy(), np.asarray(want_idx),
                                          err_msg=f"sampled L{k}")
        np.testing.assert_allclose(got["encoder_xyz"][k + 1].numpy(),
                                   np.asarray(out["encoder_xyz"][k + 1]), atol=1e-6)
        want_bq = j_bb.ball_query_multi(
            tuple(sa.RADIUS_LIST[k]), tuple(sa.NSAMPLE_LIST[k]),
            jnp.asarray(out["encoder_xyz"][sa.LAYER_INPUT[k]]),
            jnp.asarray(out["encoder_xyz"][k + 1]))
        for g, w in zip(got["ball_query_idx"][k], want_bq):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"ball L{k}")
    np.testing.assert_allclose(got["centers_features"].numpy(),
                               np.asarray(out["centers_features"]), atol=1e-3)


def test_fps_features_opcheck():
    """The F-FPS op's schema, fake implementation and dispatch
    (``torch.library.opcheck``), as ``tests/test_torch_export.py`` checks
    the other kernel ops."""
    feats = torch.from_numpy(_feats(2, 40, 6, 3))
    assert s.fps_features_op._qualname == "pdanet_tpu_torch::fps_features"
    result = torch.library.opcheck(s.fps_features_op, (feats, 10))
    assert set(result.values()) == {"SUCCESS"}, result
