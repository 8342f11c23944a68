"""The PointRCNN slice of pdanet_tpu_torch against the JAX package, on the
CPU, at ``tests/test_pointrcnn.py``'s tiny config (``POINTRCNN_MODEL_CFG``:
a two-level MSG backbone over 256 points, 32 pooled points a RoI, SA stages
``[16, -1]``): inputs from a numpy seed, weights carried from the flax
variables by the weight bridge.  The detector's own checks are in
``test_torch_pointrcnn_net.py``.

* ``roipoint_pool3d``: the pooled points' positions (an index channel) and
  the empty flags equal to JAX's (vmapped over the frames) for full, short
  (cycled) and empty RoIs, the pooled values within 1e-6 (float32); the
  float64 gradients on the points and features within 1e-12;
* ``three_interpolate``: float32 within 1e-5, float64 within 1e-12, its
  float64 gradients within 1e-12;
* ``PointNet2MSG`` (its SA and FP modules) in training mode: float32
  features and running statistics within 1e-5 of their largest |value|,
  float64 features within 1e-12 and the gradients of a random projection
  within 1e-10 of each leaf's largest |gradient|;
* ``PointRCNNHeadNet`` (``USE_BN`` off and on) in training mode with
  ``DP_RATIO`` and JAX's dropout masks fed, and at eval: outputs within
  1e-5, statistics within 1e-5; its SA stages' FPS and ball-query indices
  equal to JAX's on the same clouds;
* the shipped ``pointrcnn.yaml`` and ``pointrcnn_iou.yaml`` built at full
  width and filled from a JAX tree, every leaf consumed.
"""

import contextlib
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.backbones_3d import pointnet2_backbone as j_pn2
from pdanet_tpu.models.roi_heads import pointrcnn_head as j_prh
from pdanet_tpu.ops import ball_query as j_bq
from pdanet_tpu.ops import interpolate as j_interp
from pdanet_tpu.ops import roi_pool as j_rp
from pdanet_tpu.ops import sampling as j_sampling
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d import pointnet2_backbone as pn2
from pdanet_tpu_torch.models.detectors import get_post_processor, voxel_rcnn
from pdanet_tpu_torch.models.detectors.point_rcnn import PointRCNN
from pdanet_tpu_torch.models.roi_heads import pointrcnn_head as prh
from pdanet_tpu_torch.ops import interpolate, roi_pool
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_pointrcnn import POINTRCNN_MODEL_CFG
from test_torch_parta2 import _gap, random_variables
from test_torch_pointpillar import _perturb, _stats_close
from test_torch_second import _exact_f64

REPO = Path(__file__).resolve().parent.parent
YAMLS = REPO / "tools" / "cfgs" / "kitti_models"
CLASSES = ("Car", "Pedestrian")
B, N = 2, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def make_points(seed=2, dtype=np.float32):
    """B frames of N points as ``test_pointrcnn.py`` draws them (x in [0,
    6.4), y in [-3.2, 3.2), z in [-3, 1), an intensity)."""
    rs = np.random.RandomState(seed)
    return np.concatenate([rs.uniform(0, 6.4, (B, N, 1)), rs.uniform(-3.2, 3.2, (B, N, 1)),
                           rs.uniform(-3, 1, (B, N, 1)), rs.rand(B, N, 1)],
                          axis=-1).astype(dtype)


# ---------------------------------------------------------------- the ops

def _pool_inputs(seed, dtype):
    """Four rotated RoIs a frame: one holding 50 points (more than K), one
    holding 7 (cycled), one empty, one holding 20; the points inside at
    most 0.85 of each half extent from the centre (none near a face), the
    rest far from every RoI; features [index | 4 random channels]."""
    rs = np.random.RandomState(seed)
    rois = np.array([[1.0, 0.5, -0.5, 2.0, 1.2, 1.0, 0.4], [3.0, -1.0, 0.0, 1.0, 1.0, 1.5, -1.2],
                     [6.0, 2.0, 0.0, 0.6, 0.6, 0.6, 0.0], [2.0, 2.5, -0.2, 3.0, 1.5, 1.2, 2.8]])
    rois = np.stack([rois, rois[[3, 1, 2, 0]] + [0.1, 0.1, 0.0, 0.0, 0.0, 0.0, 0.3]])
    P = 120
    pts = np.zeros((B, P, 3))
    for b in range(B):
        chunks = []
        for r, n in zip(rois[b], (50, 7, 0, 20) if b == 0 else (20, 7, 0, 50)):
            local = rs.uniform(-0.85, 0.85, (n, 3)) * r[3:6] / 2
            c, s = np.cos(r[6]), np.sin(r[6])
            chunks.append(np.stack([local[:, 0] * c - local[:, 1] * s + r[0],
                                    local[:, 0] * s + local[:, 1] * c + r[1],
                                    local[:, 2] + r[2]], -1))
        inside = np.concatenate(chunks)
        far = rs.uniform([20, -10, -3], [30, 10, 1], (P - len(inside), 3))
        pts[b] = rs.permutation(np.concatenate([inside, far]))
    feats = np.concatenate([np.broadcast_to(np.arange(P, dtype=np.float64)[None, :, None],
                                            (B, P, 1)), rs.randn(B, P, 4)], -1)
    return [a.astype(dtype) for a in (rois, pts, feats)]


def test_roipoint_pool3d_equals_jax():
    """K = 32: the pooled positions (the index channel) and the empty flags
    equal to JAX's, a full RoI its first 32 in-box points in scan order, a
    short one cycled, an empty one zeros; the values within 1e-6."""
    K = 32
    rois, pts, feats = _pool_inputs(0, np.float32)
    want, want_empty = jax.device_get(jax.vmap(lambda r, p, f: j_rp.roipoint_pool3d(
        r, p, f, K))(*(jnp.asarray(a) for a in (rois, pts, feats))))
    got, empty = roi_pool.roipoint_pool3d(*(torch.from_numpy(a) for a in (rois, pts, feats)), K)
    np.testing.assert_array_equal(empty.numpy(), want_empty)
    assert want_empty.tolist() == [[False, False, True, False]] * 2
    np.testing.assert_array_equal(got[..., 3].numpy(), want[..., 3])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    short = got[0, 1, :, 3].numpy()
    assert len(set(short.tolist())) == 7 and (short[7:14] == short[:7]).all()
    assert (got[0, 2] == 0).all()


def test_roipoint_pool3d_gradient_equals_jax_float64():
    """The float64 gradient of a random projection of the pooled clouds on
    the points and features: within 1e-12 of JAX's (cycled slots add up)."""
    K = 32
    rois, pts, feats = _pool_inputs(1, np.float64)
    proj = np.random.RandomState(2).randn(B, 4, K, 8)
    with _exact_f64():
        def f(p, x):
            pooled, _ = jax.vmap(lambda r, p_, f_: j_rp.roipoint_pool3d(r, p_, f_, K))(
                jnp.asarray(rois), p, x)
            return (pooled * proj).sum()

        want_p, want_x = jax.device_get(jax.grad(f, argnums=(0, 1))(jnp.asarray(pts),
                                                                    jnp.asarray(feats)))
    p = torch.from_numpy(pts).requires_grad_()
    x = torch.from_numpy(feats).requires_grad_()
    pooled, _ = roi_pool.roipoint_pool3d(torch.from_numpy(rois), p, x, K)
    (pooled * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want_x, atol=1e-12, rtol=0)
    np.testing.assert_allclose(p.grad.numpy(), want_p, atol=1e-12, rtol=0)
    assert np.abs(want_x).max() > 0


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
def test_three_interpolate_equals_jax(dtype, tol):
    """The weighted gather within ``tol`` of JAX's; in float64 its gradients
    on the features and the weights within 1e-12."""
    rs = np.random.RandomState(3)
    feats = rs.randn(B, 40, 6).astype(dtype)
    idx = rs.randint(0, 40, (B, 90, 3)).astype(np.int32)
    weight = rs.rand(B, 90, 3).astype(dtype)
    ctx = _exact_f64() if dtype == "float64" else contextlib.nullcontext()
    with ctx:
        args = (jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(weight))
        want = np.asarray(jax.jit(j_interp.three_interpolate)(*args))
        if dtype == "float64":
            proj = rs.randn(B, 90, 6)
            wf, ww = jax.device_get(jax.grad(lambda f, w: (j_interp.three_interpolate(
                f, args[1], w) * proj).sum(), argnums=(0, 1))(args[0], args[2]))
    f = torch.from_numpy(feats).requires_grad_()
    w = torch.from_numpy(weight).requires_grad_()
    got = interpolate.three_interpolate(f, torch.from_numpy(idx), w)
    assert _gap(got.detach(), want) <= tol
    if dtype == "float64":
        (got * torch.from_numpy(proj)).sum().backward()
        np.testing.assert_allclose(f.grad.numpy(), wf, atol=1e-12, rtol=0)
        np.testing.assert_allclose(w.grad.numpy(), ww, atol=1e-12, rtol=0)


# ---------------------------------------------------------------- the backbone

def _backbone_pair(dtype):
    cfg = POINTRCNN_MODEL_CFG["BACKBONE_3D"]
    jnet = j_pn2.PointNet2MSG(model_cfg=JEasyDict(cfg), input_channels=4)
    pts = make_points(4)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                       random_variables(jnet, (jnp.asarray(pts),), 5))
    net = pn2.PointNet2MSG(EasyDict(cfg), 4)
    if dtype == np.float64:
        net = net.double()
    load_jax_variables(net, variables)
    return jnet, net, variables, pts.astype(dtype)


def test_pointnet2_msg_equals_jax_float32():
    """Training mode in float32: the FP decoder's point features and every
    running statistic within 1e-5 of their largest |value|."""
    jnet, net, variables, pts = _backbone_pair(np.float32)
    out_w, mut = jax.device_get(jax.jit(lambda v: jnet.apply(
        v, jnp.asarray(pts), train=True, mutable=["batch_stats"]))(variables))
    net.train()
    out = net(torch.from_numpy(pts))
    assert out["point_features"].shape == (B, N, 16)
    assert _gap(out["point_features"].detach(), out_w["point_features"]) <= 1e-5
    got = dict(net.named_buffers())
    stats = jax.tree_util.tree_flatten_with_path(mut["batch_stats"])[0]
    for path, v in stats:
        *mods, leaf = [p.key for p in path]
        key = ".".join(mods + [{"mean": "running_mean", "var": "running_var"}[leaf]])
        assert _gap(got[key], v) <= 1e-5, key
    assert len(stats) == len(got)


def test_pointnet2_msg_equals_jax_float64():
    """Training mode in float64: the point features within 1e-12 of their
    largest |value|, the gradients of a random projection of them within
    1e-10 of each leaf's largest |gradient|."""
    jnet, net, variables, pts = _backbone_pair(np.float64)
    proj = np.random.RandomState(7).randn(B, N, 16)
    with _exact_f64():
        def loss_fn(params):
            out, _ = jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(pts), train=True, mutable=["batch_stats"])
            return (out["point_features"] * proj).sum(), out["point_features"]

        (_, want), grads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"]))
    net.train()
    out = net(torch.from_numpy(pts))
    assert _gap(out["point_features"].detach(), want) <= 1e-12
    (out["point_features"] * torch.from_numpy(proj)).sum().backward()
    ref = pn2.PointNet2MSG(EasyDict(POINTRCNN_MODEL_CFG["BACKBONE_3D"]), 4).double()
    load_jax_variables(ref, {"params": grads, "batch_stats": variables["batch_stats"]})
    want_g = dict(ref.named_parameters())
    worst = max((_gap(p.grad, want_g[n].detach()), n) for n, p in net.named_parameters())
    assert worst[0] <= 1e-10, worst


def pointrcnn_cfg(dp_ratio=0.0, score_type="cls"):
    cfg = copy.deepcopy(POINTRCNN_MODEL_CFG)
    cfg["ROI_HEAD"]["DP_RATIO"] = dp_ratio
    cfg["ROI_HEAD"]["TARGET_CONFIG"]["CLS_SCORE_TYPE"] = score_type
    return cfg


# ---------------------------------------------------------------- the RoI head

class _Record:
    """The FPS and ball-query calls of ``module``'s namespace: their inputs
    and outputs, in call order."""

    def __init__(self, mp, module):
        self.fps, self.bq = [], []
        real_fps, real_bq = module.farthest_point_sample, module.ball_query

        def fps(xyz, npoint):
            out = real_fps(xyz, npoint)
            self.fps.append((xyz.detach().clone(), npoint, out))
            return out

        def bq(radius, nsample, xyz, new_xyz, site=""):
            out = real_bq(radius, nsample, xyz, new_xyz, site)
            self.bq.append((radius, nsample, xyz.detach().clone(), new_xyz.detach().clone(),
                            site, out))
            return out

        mp.setattr(module, "farthest_point_sample", fps)
        mp.setattr(module, "ball_query", bq)

    def check_against_jax(self):
        """Each recorded FPS and ball query equal to the JAX op's on the same
        inputs; the ball queries named the RoI site."""
        assert self.fps and self.bq
        for xyz, npoint, out in self.fps:
            want = np.asarray(j_sampling.farthest_point_sample(jnp.asarray(xyz.float().numpy()),
                                                                npoint))
            np.testing.assert_array_equal(out.numpy(), want)
        for radius, nsample, xyz, new_xyz, site, out in self.bq:
            assert site == prh.BALL_QUERY_SITE
            want = np.asarray(j_bq.ball_query(radius, nsample, jnp.asarray(xyz.numpy()),
                                              jnp.asarray(new_xyz.numpy())))
            np.testing.assert_array_equal(out.numpy(), want)


def _head_cfg(**over):
    cfg = copy.deepcopy(POINTRCNN_MODEL_CFG["ROI_HEAD"])
    cfg["CLS_FC"], cfg["REG_FC"] = [16, 8], [8]
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("use_bn", [False, True])
def test_pointrcnn_head_equals_jax(use_bn):
    """``PointRCNNHeadNet`` over 6 RoIs a frame (one empty, extra pool width
    0.2 m) in training mode, ``DP_RATIO`` 0.3 with JAX's keep masks (read
    off its Dropout calls) fed: ``rcnn_cls`` / ``rcnn_reg`` within 1e-5 and
    the statistics within 1e-5 relative; at eval within 1e-5; the SA
    stages' FPS and ball-query indices equal to JAX's on the port's
    clouds.  ``USE_BN`` True batch-norms ``xyz_up`` / ``merge_down`` too."""
    cfg = _head_cfg(DP_RATIO=0.3, USE_BN=use_bn)
    cfg["ROI_POINT_POOL"] = {**cfg["ROI_POINT_POOL"], "POOL_EXTRA_WIDTH": [0.2, 0.2, 0.2]}
    rs = np.random.RandomState(8)
    R, C = 6, 16
    pts = make_points(9)[..., :3]
    rois = np.concatenate([pts[:, rs.randint(0, N, R), :3] + rs.uniform(-0.3, 0.3, (B, R, 3)),
                           rs.uniform(0.8, 2.5, (B, R, 3)), rs.uniform(-3, 3, (B, R, 1))],
                          axis=-1).astype(np.float32)
    rois[:, 2, :3] = [40.0, 40.0, 0.0]
    feats = np.maximum(rs.randn(B, N, C), 0).astype(np.float32)
    scores = rs.rand(B, N).astype(np.float32)
    inputs = (pts, feats, scores, rois)
    jhead = j_prh.PointRCNNHeadNet(model_cfg=JEasyDict(cfg), code_size=7, num_class=1)
    args = [jnp.asarray(a) for a in inputs]
    variables = _perturb(jhead.init(jax.random.PRNGKey(0), *args), 9)
    port = prh.PointRCNNHeadNet(EasyDict(cfg), C, 7, 1)
    load_jax_variables(port, variables)
    assert port.dropout_shapes(R) == {"cls0": (R, 16), "reg0": (R, 8)}
    masks = []

    def record(next_fun, fargs, kwargs, context):
        out = next_fun(*fargs, **kwargs)
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            masks.append(out != 0)
        return out

    with fnn.intercept_methods(record):
        (cls_w, reg_w), mut = jhead.apply(variables, *args, train=True, mutable=["batch_stats"],
                                          rngs={"dropout": jax.random.PRNGKey(8)})
    assert len(masks) == 2
    keep = {name: torch.from_numpy(np.array(m)).reshape(B, R, -1)
            for name, m in zip(("cls0", "reg0"), masks)}
    port.train()
    t_in = [torch.from_numpy(a) for a in inputs]
    with pytest.MonkeyPatch.context() as mp:
        rec = _Record(mp, prh)
        cls_g, reg_g = port(*t_in, keep)
    rec.check_against_jax()
    assert [(x.shape[0], x.shape[1], k) for x, k, _ in rec.fps] == [(B * R, 32, 16)]
    np.testing.assert_allclose(cls_g.detach().numpy(), np.asarray(cls_w), atol=1e-5, rtol=0)
    np.testing.assert_allclose(reg_g.detach().numpy(), np.asarray(reg_w), atol=1e-5, rtol=0)
    _stats_close(port, jax.tree_util.tree_map(np.asarray, mut["batch_stats"]), atol=1e-5)
    load_jax_variables(port, variables)
    port.eval()
    with torch.no_grad():
        cls_g, reg_g = port(*t_in)
    cls_w, reg_w = jax.jit(lambda v: jhead.apply(v, *args, train=False))(variables)
    np.testing.assert_allclose(cls_g.numpy(), np.asarray(cls_w), atol=1e-5, rtol=0)
    np.testing.assert_allclose(reg_g.numpy(), np.asarray(reg_w), atol=1e-5, rtol=0)
    pooled = port.pool(*t_in[:3], t_in[3])
    assert (pooled[:, 2] == 0).all() and (pooled[:, [0, 1, 3]] != 0).any(-1).all()


@pytest.mark.parametrize("yaml_name", ["pointrcnn", "pointrcnn_iou"])
def test_build_network_pointrcnn_yaml(yaml_name):
    """The shipped yaml at full width through the dataset (4 input
    channels): ``PointRCNN`` over a 4-level MSG backbone into 128-wide point
    features, the RoI head's SA stages and stacks, on CUDA unless told (this
    torch has none: raises); every leaf of the JAX package's tree consumed;
    the serving spec the points at 16384; the refined post-processing."""
    cfg = cfg_from_yaml_file(str(YAMLS / f"{yaml_name}.yaml"))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert type(model) is PointRCNN
    assert model.backbone_3d.num_point_features == 128
    assert model.backbone_3d.SA_modules_3.mlps_1.layer2.dense.out_features == 512
    assert model.backbone_3d.FP_modules_3.mlp.layer0.dense.in_features == 1024 + 512
    assert model.roi_head.SA_2.mlp.fc0.in_features == 256 + 3
    assert model.roi_head.merge_down.fc0.in_features == 128 + 128
    assert model.roi_head.dropout_shapes(128) == {}
    spec = serving.serving_input_spec(cfg, 1, model)
    assert spec == {"points": ((1, 16384, 4), torch.float32)}
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=3, input_channels=4)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 16384, 4), jnp.float32)))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rs.rand(*s.shape).astype(np.float32), shapes)
    load_jax_variables(model, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    assert get_post_processor("PointRCNN") is voxel_rcnn.post_processing
