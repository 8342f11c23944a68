"""The dynamic VFEs of pdanet_tpu_torch against the JAX package, on the
CPU, at the sizes of ``tests/test_dynamic_vfe.py`` (a 32 x 32 x 8 grid of
0.2 x 0.2 x 0.5 m over a 6.4 x 6.4 x 4 m range; clouds from a numpy seed
with points out of range and on cell borders).  The JAX side runs jitted:
XLA computes ``(x - origin) / voxel`` as a product with the reciprocal,
which moves a point on a cell border into the cell below; the port
computes the cells so (equal on the borders).

* ``DynamicMeanVFE``: the occupied cells equal, the means within 1e-6 of
  max(1, |value|) in float32 and 1e-12 in float64 (the port sums a cell in
  float64 by sorted segments, JAX in the points' dtype in scan order), the
  same bits on a second run.
* ``DynamicPillarVFE`` in training mode, float32: the BEV canvas within
  1e-5 of its largest |value|, the running statistics within 1e-6.
* SECOND over ``DynamicMeanVFE`` and the dense ``VoxelBackBone8x``, and
  PointPillar over ``DynamicPillarVFE``, in training mode in float64: the
  loss and its terms within 1e-10 relative, every gradient leaf within
  1e-10 of its largest |gradient|, the running statistics within 1e-9
  (the dense ladder's masked BatchNorm sums the active cells, JAX's the
  masked grid).
* ``UNetV2`` over the dynamic grid: the BEV map and the decoder's features
  at the occupied cells within 1e-5 of max(1, |value|) of JAX's UNetV2 fed
  those cells as a voxel list (JAX's read-back fails without a list).
* The device batch (``points``, ``gt_boxes``) and ``serving_input_spec``
  as the JAX package's (a ValueError without ``sample_points``).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu import serving as j_serving
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.backbones_3d.vfe.dynamic_mean_vfe import DynamicMeanVFE as JMeanVFE
from pdanet_tpu.models.backbones_3d.vfe.dynamic_pillar_vfe import (
    DynamicPillarVFE as JPillarVFE)
from pdanet_tpu.models.backbones_3d.voxel_unet import UNetV2 as JUNetV2
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d.vfe.dynamic_mean_vfe import DynamicMeanVFE
from pdanet_tpu_torch.models.backbones_3d.vfe.dynamic_pillar_vfe import DynamicPillarVFE
from pdanet_tpu_torch.models.backbones_3d.voxel_unet import UNetV2
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_dynamic_vfe import GRID, PC_RANGE, VOXEL_SIZE
from test_pointpillar import PP_MODEL_CFG
from test_second import SECOND_MODEL_CFG
from test_torch_caddn import REPO
from test_torch_pointpillar import _perturb, _stats_close

CLASSES = ("Car", "Pedestrian")
PILLAR_CFG = {"NAME": "DynamicPillarVFE", "WITH_DISTANCE": True, "USE_ABSLOTE_XYZ": True,
              "USE_NORM": True, "NUM_FILTERS": [8, 16]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def cloud(B=2, N=600, seed=0):
    """(B, N, 4) float32: uniform over the range and 10 % beyond it, every
    tenth point moved onto a cell border (a multiple of the float32 voxel
    size), clusters of points sharing cells."""
    rs = np.random.RandomState(seed)
    lo, hi = np.array(PC_RANGE[:3]), np.array(PC_RANGE[3:])
    pts = rs.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo), (B, N, 3))
    vs = np.asarray(VOXEL_SIZE, np.float32)
    cells = rs.randint(0, np.asarray(GRID), (B, N // 10, 3))
    pts[:, ::10] = cells * vs + np.asarray(PC_RANGE[:3], np.float32)
    pts[:, 1::10] = pts[:, 2::10] + rs.uniform(-0.02, 0.02, (B, N // 10, 3))
    feats = np.concatenate([pts, rs.rand(B, N, 1)], axis=-1)
    return feats.astype(np.float32)


def _variables(shapes, seed, dtype=np.float32):
    """A flax tree of random weights at ``shapes`` (``jax.eval_shape`` of
    ``init``, no compile): kernels scaled by 1 / sqrt(fan-in), BatchNorm
    statistics and affine parameters drawn as ``_perturb`` draws them."""
    rs = np.random.RandomState(seed)

    def one(path, s):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rs.normal(0.0, fan_in ** -0.5, s.shape)
        return np.zeros(s.shape) if path[-1].key != "var" else np.ones(s.shape)

    tree = jax.tree_util.tree_map_with_path(one, shapes)
    return _perturb(tree, seed + 1, dtype)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_dynamic_mean_vfe_equals_jax(dtype, tol):
    pts = cloud().astype(dtype)
    vfe = JMeanVFE(model_cfg={}, num_point_features=4, grid_size=GRID,
                   voxel_size=VOXEL_SIZE, point_cloud_range=PC_RANGE)
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        want = np.asarray(jax.jit(lambda p: vfe.apply({}, p))(pts))
    finally:
        jax.config.update("jax_enable_x64", False)
    port = DynamicMeanVFE({}, 4, GRID, VOXEL_SIZE, PC_RANGE)
    got = port(torch.from_numpy(pts)).numpy()
    assert got.shape == (2, 8, 32, 32, 4) and got.dtype == dtype
    np.testing.assert_array_equal((got != 0).any(-1), (want != 0).any(-1))
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, err.max()
    np.testing.assert_array_equal(port(torch.from_numpy(pts)).numpy(), got)


def test_dynamic_pillar_vfe_equals_jax():
    pts = cloud(seed=1)
    grid = (GRID[0], GRID[1], 1)
    vs = (VOXEL_SIZE[0], VOXEL_SIZE[1], 4.0)
    jvfe = JPillarVFE(model_cfg=PILLAR_CFG, num_point_features=4, grid_size=grid,
                      voxel_size=vs, point_cloud_range=PC_RANGE)
    variables = _variables(jax.eval_shape(lambda: jvfe.init(jax.random.PRNGKey(0), pts)), 2)
    want, mut = jax.jit(lambda v, p: jvfe.apply(v, p, train=True, mutable=["batch_stats"]))(
        variables, pts)
    port = DynamicPillarVFE(PILLAR_CFG, 4, grid, vs, PC_RANGE).train()
    load_jax_variables(port, variables)
    got = port(torch.from_numpy(pts)).detach().numpy()
    assert got.shape == (2, 32, 32, 16)
    assert (got == 0).all(-1).mean() > 0.3 and (got != 0).any(-1).mean() > 0.3
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    _stats_close(port, mut["batch_stats"], atol=1e-6)


def _dynamic_cfg(base, vfe):
    cfg = copy.deepcopy(dict(base))
    cfg["VFE"] = vfe
    return cfg


GT = np.zeros((2, 3, 8), np.float32)
GT[0, 0] = [3.0, 0.5, -0.8, 3.9, 1.6, 1.56, 0.3, 1]
GT[0, 1] = [1.5, -1.0, -0.2, 0.8, 0.6, 1.73, -0.5, 2]
GT[1, 0] = [4.2, 1.5, -1.0, 3.6, 1.5, 1.5, 1.2, 1]

DETECTORS = {
    "SECOND": (_dynamic_cfg(SECOND_MODEL_CFG, {"NAME": "DynamicMeanVFE"}),
               dict(grid_size=GRID, voxel_size=VOXEL_SIZE)),
    "PointPillar": (_dynamic_cfg(PP_MODEL_CFG, {**PILLAR_CFG, "NUM_FILTERS": [16]}),
                    dict(grid_size=(32, 32, 1), voxel_size=(0.2, 0.2, 4.0))),
}


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_detector_over_dynamic_vfe_matches_jax_float64(name):
    cfg, geometry = DETECTORS[name]
    geometry = dict(geometry, point_cloud_range=PC_RANGE, class_names=CLASSES)
    pts = cloud(seed=2).astype(np.float64)
    jmodel = j_build(JEasyDict(cfg), num_class=2, **geometry)
    assert jmodel.DEVICE_BATCH_KEYS == ("points", "gt_boxes")
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), pts.astype(np.float32),
                                                None, None))
    variables = _variables(shapes, 3, np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        def loss_fn(params, p, gt):
            out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    p, None, None, train=True, mutable=["batch_stats"])
            loss, tb = jmodel.apply(variables, out, gt, list(CLASSES), method=jmodel.loss)
            return loss, (tb, mut["batch_stats"])

        (loss, (tb, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], pts, GT.astype(np.float64))
        loss, tb = float(loss), {k: float(v) for k, v in tb.items()}
        grads, stats = jax.device_get(grads), jax.device_get(stats)
    finally:
        jax.config.update("jax_enable_x64", False)

    model = build_network(EasyDict(cfg), 2, device="cpu", **geometry).double().train()
    assert model.DEVICE_BATCH_KEYS == ("points", "gt_boxes")
    load_jax_variables(model, variables)
    batch = {"points": torch.from_numpy(pts), "gt_boxes": torch.from_numpy(GT).double()}
    got_loss, got_tb = model.loss_batch(model.forward_batch(batch), batch)
    got_tb = {k: float(v) for k, v in got_tb.items()}
    got_loss.backward()
    assert loss > 0 and abs(got_loss.item() - loss) <= 1e-10 * loss
    for k, w in tb.items():
        assert abs(got_tb[k] - w) <= 1e-10 * max(abs(w), 1e-3), k
    ref = build_network(EasyDict(cfg), 2, device="cpu", **geometry).double()
    load_jax_variables(ref, {"params": grads, "batch_stats": variables["batch_stats"]})
    worst = max((p.grad - dict(ref.named_parameters())[n]).abs().max().item()
                / max(dict(ref.named_parameters())[n].abs().max().item(), 1e-12)
                for n, p in model.named_parameters())
    assert worst <= 1e-10, worst
    _stats_close(model, stats, atol=1e-9)


def test_unet_v2_over_dynamic_grid_equals_jax():
    pts = cloud(B=1, N=900, seed=4)
    grid = np.asarray(DynamicMeanVFE({}, 4, GRID, VOXEL_SIZE, PC_RANGE)(torch.from_numpy(pts)))
    cells = np.argwhere((grid[0] != 0).any(-1))  # (V, 3) zyx
    coords, feats = cells[None].astype(np.int32), grid[0][tuple(cells.T)][None]
    junet = JUNetV2(model_cfg={}, input_channels=4, grid_size=GRID)
    variables = _variables(jax.eval_shape(
        lambda: junet.init(jax.random.PRNGKey(0), feats, coords)), 5)
    bev, aux = jax.jit(lambda v, f, c: junet.apply(v, f, c))(variables, feats, coords)
    port = UNetV2({}, 4, GRID).eval()
    load_jax_variables(port, variables)
    with torch.no_grad():
        got_bev, got_aux = port(torch.from_numpy(grid), None)
    assert float(np.abs(np.asarray(bev)).max()) > 0
    np.testing.assert_allclose(got_bev.numpy(), bev, atol=1e-5, rtol=1e-5)
    at = got_aux["point_features"][0].numpy()[tuple(cells.T)]
    np.testing.assert_allclose(at, np.asarray(aux["point_features"])[0], atol=1e-5, rtol=1e-5)
    assert got_aux["point_valid"][0, :GRID[2]].numpy().sum() == len(cells)


def test_device_keys_and_serving_spec_as_jax():
    cfg = cfg_from_yaml_file(str(REPO / "tools" / "cfgs" / "kitti_models" / "pointpillar.yaml"))
    cfg.MODEL.VFE = EasyDict({**PILLAR_CFG, "NUM_FILTERS": [64]})
    geometry = dict(grid_size=(432, 496, 1), voxel_size=(0.16, 0.16, 4.0),
                    point_cloud_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE),
                    class_names=tuple(cfg.CLASS_NAMES))
    model = build_network(cfg.MODEL, 3, device="cpu", **geometry)
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=3, **geometry)
    assert model.DEVICE_BATCH_KEYS == jmodel.DEVICE_BATCH_KEYS == ("points", "gt_boxes")
    for fn, m in ((serving.serving_input_spec, model), (j_serving.serving_input_spec, jmodel)):
        with pytest.raises(ValueError, match="sample_points"):
            fn(cfg, 1, m)
    cfg.DATA_CONFIG.DATA_PROCESSOR.append(EasyDict(
        {"NAME": "sample_points", "NUM_POINTS": {"train": 16384, "test": 16384}}))
    spec = serving.serving_input_spec(cfg, 2, model)
    jspec = j_serving.serving_input_spec(cfg, 2, jmodel)
    assert {k: s for k, (s, _) in spec.items()} == {k: s for k, (s, _) in jspec.items()} == {
        "points": (2, 16384, 4)}
