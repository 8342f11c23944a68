"""The PV-RCNN slice of pdanet_tpu_torch against the JAX package, on the
CPU, at ``tests/test_pvrcnn.py``'s tiny config (``PVRCNN_MODEL_CFG``: a
32 x 32 x 8 grid of 0.2 x 0.2 x 0.5 m cells, 32 keypoints, every feature
source, a 3 x 3 x 3 RoI grid) over the dense ``VoxelBackBone8x`` and the
sparse ``SparseVoxelBackBone8x``: inputs from a numpy seed (voxels in
clusters, padded rows; half the raw points near the voxels), weights
carried from the flax variables by the weight bridge.

* ``multi_scale_occupancy`` equal (both z-padding rules),
  ``dense_to_voxel_list`` and ``sparse_to_voxel_list`` equal (centres within
  1e-6, a dense level cut at its budget), ``bilinear_interpolate`` within
  1e-6 against JAX and the reference's formula;
* ``MaskedSAModuleMSG``: the ball query's indices equal over supports with
  ``FAR_SENTINEL`` rows, empty balls exactly 0, outputs within 1e-5 and
  the running statistics within 1e-5 relative;
* ``point_head_simple_loss`` within 1e-6 (float32) and 1e-12 (float64);
* ``PVRCNNHeadNet`` with a three-layer ``SHARED_FC`` in training, JAX's
  dropout masks fed: outputs within 1e-5;
* ``PVRCNN`` at eval in float32: the keypoints equal, the RoIs equal, the
  fused keypoint features within 1e-3, the logits within 2e-3, the
  detections paired box for box; in training mode in float64
  (``DP_RATIO`` 0, JAX's sampler draws fed, ``CLS_SCORE_TYPE`` cls): the
  loss and its tb terms within 1e-10 relative, every gradient leaf within
  1e-10 of its largest |gradient|, the running statistics within 1e-9;
* the tiny exported program equal to the eager closure; the shipped
  ``pv_rcnn.yaml`` built through the dataset's geometry (on CUDA unless
  told) and filled by a JAX tree of the same config; its serving spec
  equal to JAX's.

Float64 on the JAX side drops the sparse conv's float32
``preferred_element_type`` (``test_torch_second._exact_f64``).
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

from pdanet_tpu import serving as j_serving
from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.backbones_3d.pfe import voxel_set_abstraction as j_vsa
from pdanet_tpu.models.dense_heads import point_head_simple as j_ph
from pdanet_tpu.models.detectors import voxel_rcnn as j_vrcnn
from pdanet_tpu.models.roi_heads import pvrcnn_head as j_pvh
from pdanet_tpu.models.roi_heads import roi_head_template as JRHT
from pdanet_tpu.ops.ball_query import ball_query_multi as j_ball_query_multi
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d.pfe import voxel_set_abstraction as vsa
from pdanet_tpu_torch.models.blocks import init_random_weights
from pdanet_tpu_torch.models.dense_heads.point_head_simple import point_head_simple_loss
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.models.detectors.pv_rcnn import PVRCNN
from pdanet_tpu_torch.models.detectors.second import SECOND
from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT
from pdanet_tpu_torch.models.roi_heads.pvrcnn_head import PVRCNNHeadNet
from pdanet_tpu_torch.ops.ball_query import ball_query_multi
from pdanet_tpu_torch.ops.rotated_iou import boxes_iou3d
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_pvrcnn import GRID, PC_RANGE, PVRCNN_MODEL_CFG, VOXEL_SIZE
from test_torch_pointpillar import _match, _perturb, _stats_close
from test_torch_second import _exact_f64, clustered_coords
from test_torch_voxel_rcnn import FEED_KEY, _stack_draws, jax_sampler_draws

REPO = Path(__file__).resolve().parent.parent
YAML = REPO / "tools" / "cfgs" / "kitti_models" / "pv_rcnn.yaml"
CLASSES = ("Car", "Pedestrian")
GEOMETRY = dict(grid_size=GRID, voxel_size=VOXEL_SIZE, point_cloud_range=PC_RANGE,
                class_names=CLASSES)
B, V, P, N = 2, 160, 5, 256
BACKBONES = ("VoxelBackBone8x", "SparseVoxelBackBone8x")


def pv_cfg(backbone="SparseVoxelBackBone8x", dp_ratio=0.3, score_type="roi_iou"):
    """``test_pvrcnn.PVRCNN_MODEL_CFG`` over ``backbone``.  The float64 step
    takes ``CLS_SCORE_TYPE`` cls and ``DP_RATIO`` 0, as for Voxel-RCNN
    (``test_torch_voxel_rcnn.vrcnn_cfg``)."""
    cfg = copy.deepcopy(PVRCNN_MODEL_CFG)
    cfg["BACKBONE_3D"]["NAME"] = backbone
    cfg["ROI_HEAD"]["DP_RATIO"] = dp_ratio
    cfg["ROI_HEAD"]["TARGET_CONFIG"]["CLS_SCORE_TYPE"] = score_type
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def make_batch(seed=3, n_valid=(140, 118)):
    """B frames: the voxel triplet on the tiny grid (clustered distinct
    cells, as the dense ladder wants them, padded rows, voxels of 1-5
    points) and N raw points, half within 0.3 m of a voxel's centre, half
    uniform over the range."""
    rs = np.random.RandomState(seed)
    coords = np.stack([clustered_coords(rs, n, grid=GRID, V_=V, dups=0, clusters=4)
                       for n in n_valid])
    nums = rs.randint(1, P + 1, (B, V)).astype(np.int32)
    lo, hi = np.asarray(PC_RANGE[:3]), np.asarray(PC_RANGE[3:])
    voxels = np.concatenate([rs.uniform(lo, hi, (B, V, P, 3)), rs.rand(B, V, P, 1)],
                            axis=-1).astype(np.float32)
    voxels[np.arange(P)[None, None] >= nums[..., None]] = 0
    pad = coords[..., 0] < 0
    voxels[pad], nums[pad] = 0, 0
    points = np.zeros((B, N, 4), np.float32)
    for b in range(B):
        pick = rs.choice(np.flatnonzero(~pad[b]), N // 2)
        centres = (coords[b, pick, ::-1] + 0.5) * np.asarray(VOXEL_SIZE) + lo
        points[b, :N // 2, :3] = centres + rs.uniform(-0.3, 0.3, (N // 2, 3))
        points[b, N // 2:, :3] = rs.uniform(lo, hi, (N - N // 2, 3))
    points[..., 3] = rs.rand(B, N)
    return {"voxels": voxels, "voxel_coords": coords, "voxel_num_points": nums,
            "points": points}


def _tb(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if k in ("voxels", "points") else
            torch.from_numpy(v) for k, v in batch.items()}


def _args(batch, dtype=jnp.float32):
    return [jnp.asarray(batch["voxels"], dtype), jnp.asarray(batch["voxel_coords"]),
            jnp.asarray(batch["voxel_num_points"]), jnp.asarray(batch["points"], dtype)]


def _stats_rel(model, want_stats, rtol):
    """``_stats_close`` relative to each statistic (atol 1e-6 beside)."""
    got = dict(model.named_buffers())
    for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(want_stats))[0]:
        *mods, leaf = [p.key for p in path]
        name = ".".join(mods + [{"mean": "running_mean", "var": "running_var"}[leaf]])
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(v), rtol=rtol,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- the VSA's pieces

@pytest.mark.parametrize("grid", [GRID, (12, 10, 2)])
def test_multi_scale_occupancy_equals_jax(grid):
    """The occupancy pyramid at strides 1-8 equal to JAX's: the tiny grid
    (stride 4 -> 8 without z padding) and a 2-plane grid (with it), rows
    out of the grid and padded rows dropped."""
    rs = np.random.RandomState(0)
    nx, ny, nz = grid
    coords = np.stack([rs.randint(0, nz, (B, 40)), rs.randint(0, ny, (B, 40)),
                       rs.randint(0, nx, (B, 40))], axis=-1).astype(np.int32)
    coords[:, -8:] = -1
    coords[0, 3] = (nz, 0, 0)  # the reference's top z plane: kept
    coords[1, 4] = (0, ny, 0)  # out of the grid: dropped
    strides = (1, 2, 4, 8)
    want = jax.device_get(jax.jit(lambda c: j_vsa.multi_scale_occupancy(c, grid, strides))(
        jnp.asarray(coords)))
    got = vsa.multi_scale_occupancy(torch.from_numpy(coords), grid, strides)
    assert set(got) == set(want)
    for s in strides:
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want[s]), err_msg=str(s))
    assert got[8].any()


def test_voxel_lists_equal_jax():
    """``dense_to_voxel_list`` at a budget above and below the active cells
    (the first cells in zyx scan order kept), and ``sparse_to_voxel_list``:
    centres within 1e-6, ``FAR_SENTINEL`` on invalid rows, features and
    validity equal."""
    rs = np.random.RandomState(1)
    Z, Y, X, C = 3, 8, 8, 5
    occ = rs.rand(B, Z, Y, X) < 0.2
    grid = rs.randn(B, Z, Y, X, C).astype(np.float32)
    for budget in (16, 128):
        want = jax.device_get(jax.jit(lambda g, o: j_vsa.dense_to_voxel_list(
            g, o, budget, 2, VOXEL_SIZE, PC_RANGE))(jnp.asarray(grid), jnp.asarray(occ)))
        got = vsa.dense_to_voxel_list(torch.from_numpy(grid), torch.from_numpy(occ), budget, 2,
                                      VOXEL_SIZE, PC_RANGE)
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        assert (got[0].numpy()[~want[2]] == vsa.FAR_SENTINEL).all()
        assert want[2].all() if budget == 16 else not want[2].all()
    coords = np.stack([clustered_coords(rs, 50, grid=GRID, V_=64, dups=0) for _ in range(B)])
    valid = coords[..., 0] >= 0
    feats = rs.randn(B, 64, C).astype(np.float32)
    entry = (coords, feats, valid)
    want = jax.device_get(jax.jit(lambda *e: j_vsa.sparse_to_voxel_list(
        e, 4, VOXEL_SIZE, PC_RANGE))(*(jnp.asarray(a) for a in entry)))
    got = vsa.sparse_to_voxel_list(tuple(torch.from_numpy(a) for a in entry), 4, VOXEL_SIZE,
                                   PC_RANGE)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_bilinear_interpolate_equals_jax():
    """Clamped taps at interior, border and outside points: within 1e-6 of
    JAX and of the reference's formula."""
    rs = np.random.RandomState(3)
    im = rs.rand(4, 5, 2).astype(np.float32)
    x = np.array([0.0, 1.5, 3.9, -1.0, 10.0, 2.25], np.float32)
    y = np.array([0.0, 0.5, 2.2, -0.5, 10.0, 3.0], np.float32)
    want = np.asarray(jax.jit(j_vsa.bilinear_interpolate)(jnp.asarray(im), jnp.asarray(x),
                                                          jnp.asarray(y)))
    got = vsa.bilinear_interpolate(torch.from_numpy(im), torch.from_numpy(x),
                                   torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    H, W = im.shape[:2]
    for i in range(len(x)):
        x0, y0 = int(np.floor(x[i])), int(np.floor(y[i]))
        xs = [min(max(v, 0), W - 1) for v in (x0, x0 + 1)]
        ys = [min(max(v, 0), H - 1) for v in (y0, y0 + 1)]
        exp = (im[ys[0], xs[0]] * (x0 + 1 - x[i]) * (y0 + 1 - y[i])
               + im[ys[1], xs[0]] * (x0 + 1 - x[i]) * (y[i] - y0)
               + im[ys[0], xs[1]] * (x[i] - x0) * (y0 + 1 - y[i])
               + im[ys[1], xs[1]] * (x[i] - x0) * (y[i] - y0))
        np.testing.assert_allclose(got[i], exp, atol=1e-5, rtol=0)


@pytest.mark.parametrize("train", [False, True])
def test_masked_sa_module_equals_jax(train):
    """Two radii over a support with ``FAR_SENTINEL`` rows: the ball
    query's indices equal JAX's; centres whose balls are empty (two far
    off) give exactly 0; outputs within 1e-5
    and, in training, the running statistics within 1e-5 relative; the rel-xyz-only
    form (no features) as well."""
    rs = np.random.RandomState(2)
    xyz = rs.uniform(0, 2, (B, 48, 3)).astype(np.float32)
    xyz[:, 40:] = vsa.FAR_SENTINEL
    feats = rs.rand(B, 48, 3).astype(np.float32)
    new_xyz = rs.uniform(0, 2, (B, 10, 3)).astype(np.float32)
    new_xyz[:, 8] = 50.0
    new_xyz[:, 9] = (-3.0, 1.0, 30.0)
    radii, ks = (0.4, 0.8), (8, 16)
    want_idx = jax.device_get(j_ball_query_multi(radii, ks, jnp.asarray(xyz),
                                                 jnp.asarray(new_xyz)))
    got_idx = ball_query_multi(radii, ks, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    for g, w in zip(got_idx, want_idx):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for with_feats in (True, False):
        jmod = j_vsa.MaskedSAModuleMSG(radii=radii, nsamples=ks, mlps=((4, 6), (5,)))
        f = jnp.asarray(feats) if with_feats else None
        variables = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(xyz), f,
                                       jnp.asarray(new_xyz)), 4)
        want, mut = jax.jit(lambda v: jmod.apply(v, jnp.asarray(xyz), f, jnp.asarray(new_xyz),
                                                 train=train, mutable=["batch_stats"]))(
            variables)
        port = vsa.MaskedSAModuleMSG(3 if with_feats else 0, radii, ks, ((4, 6), (5,)))
        load_jax_variables(port, variables)
        port.train(train)
        got = port(torch.from_numpy(xyz), torch.from_numpy(feats) if with_feats else None,
                   torch.from_numpy(new_xyz)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
        assert (got[:, 8:] == 0).all() and np.abs(got[:, :8]).max() > 0
        # running variances up to ~200, float32 sums in another order
        _stats_rel(port, mut["batch_stats"], rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_point_head_loss_equals_jax(dtype):
    """The focal segmentation loss over keypoints in, beside and outside
    two gt boxes (a padded gt row), class-agnostic: within 1e-6 (float32)
    or 1e-12 (float64) of JAX's, the positive count equal."""
    rs = np.random.RandomState(5)
    gt = np.zeros((B, 3, 8), np.float64)
    gt[:, 0] = [3.0, 0.5, -0.8, 3.9, 1.6, 1.56, 0.3, 1]
    gt[:, 1] = [1.5, -1.0, -0.2, 0.8, 0.6, 1.73, -0.5, 2]
    pts = np.concatenate([gt[:, :2, None, :3] + rs.uniform(-1.2, 1.2, (B, 2, 24, 3)),
                          rs.uniform(-3, 5, (B, 1, 24, 3))], axis=1).reshape(B, 72, 3)
    preds = rs.randn(B, 72, 1)
    cfg = PVRCNN_MODEL_CFG["POINT_HEAD"]
    with _exact_f64() if dtype == "float64" else contextlib.nullcontext():
        jd = getattr(jnp, dtype)
        want, tb = jax.jit(lambda p, c, g: j_ph.point_head_simple_loss(p, c, g, JEasyDict(cfg)))(
            jnp.asarray(preds, jd), jnp.asarray(pts, jd), jnp.asarray(gt, jd))
        want, pos = float(want), float(tb["point_pos_num"])
    td = getattr(torch, dtype)
    got, tb = point_head_simple_loss(torch.from_numpy(preds).to(td),
                                     torch.from_numpy(pts).to(td),
                                     torch.from_numpy(gt).to(td), EasyDict(cfg))
    tol = 1e-6 if dtype == "float32" else 1e-12
    assert abs(got.item() - want) <= tol * abs(want), (got.item(), want)
    assert tb["point_pos_num"].item() == pos > 0


def test_pvrcnn_head_three_layer_shared_fc_equals_jax():
    """``PVRCNNHeadNet`` with ``SHARED_FC`` of three layers in training:
    dropout after shared layers 0 and 1 and after the first cls and reg
    layers (``dropout_shapes``), JAX's keep masks (read off its Dropout
    calls) fed; ``rcnn_cls`` / ``rcnn_reg`` within 1e-5, the statistics
    within 1e-6; at eval within 1e-5."""
    cfg = copy.deepcopy(PVRCNN_MODEL_CFG["ROI_HEAD"])
    cfg["SHARED_FC"] = [24, 16, 16]
    cfg["CLS_FC"], cfg["REG_FC"] = [8, 8], [8]
    rs = np.random.RandomState(6)
    R, K, C = 4, 40, 6
    coords = rs.uniform(0, 3, (B, K, 3)).astype(np.float32)
    feats = rs.rand(B, K, C).astype(np.float32)
    rois = np.concatenate([rs.uniform(0.5, 2.5, (B, R, 3)), rs.uniform(0.8, 2.0, (B, R, 3)),
                           rs.uniform(-1, 1, (B, R, 1))], axis=-1).astype(np.float32)
    jhead = j_pvh.PVRCNNHeadNet(model_cfg=JEasyDict(cfg), code_size=7, num_class=1)
    args = [jnp.asarray(a) for a in (coords, feats, rois)]
    variables = _perturb(jhead.init(jax.random.PRNGKey(0), *args), 7)
    port = PVRCNNHeadNet(EasyDict(cfg), C, 7, 1)
    load_jax_variables(port, variables)
    assert port.dropout_shapes(R) == {"shared0": (R, 24), "shared1": (R, 16), "cls0": (R, 8),
                                      "reg0": (R, 8)}
    masks = []

    def record(next_fun, fargs, kwargs, context):
        out = next_fun(*fargs, **kwargs)
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            masks.append(out != 0)
        return out

    with fnn.intercept_methods(record):
        (cls_w, reg_w), mut = jhead.apply(variables, *args, train=True, mutable=["batch_stats"],
                                          rngs={"dropout": jax.random.PRNGKey(8)})
    assert len(masks) == 4
    keep = {name: torch.from_numpy(np.array(m))
            for name, m in zip(("shared0", "shared1", "cls0", "reg0"), masks)}
    port.train()
    cls_g, reg_g = port(*(torch.from_numpy(a) for a in (coords, feats, rois)), keep)
    np.testing.assert_allclose(cls_g.detach().numpy(), np.asarray(cls_w), atol=1e-5, rtol=0)
    np.testing.assert_allclose(reg_g.detach().numpy(), np.asarray(reg_w), atol=1e-5, rtol=0)
    _stats_close(port, mut["batch_stats"], atol=1e-6)
    load_jax_variables(port, variables)  # the statistics before the training forward
    port.eval()
    with torch.no_grad():
        cls_g, reg_g = port(*(torch.from_numpy(a) for a in (coords, feats, rois)))
    cls_w, reg_w = jhead.apply(variables, *args, train=False)
    np.testing.assert_allclose(cls_g.numpy(), np.asarray(cls_w), atol=1e-5, rtol=0)
    np.testing.assert_allclose(reg_g.numpy(), np.asarray(reg_w), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="dropout keep masks"):
        port.train().refine(torch.zeros(B, R, port.shared_fc0.in_features))


# ---------------------------------------------------------------- the detector

@pytest.fixture(scope="module")
def batch():
    return make_batch()


def _gt_near(rois, labels, valid, points, seed=6):
    """Two gt boxes a frame a little off two valid RoIs (their labels), so
    that the sampler finds foreground RoIs; a third around the frame's
    first point, the first keypoint (FPS starts there), so that the point
    head has positives; and a padded row."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((B, 4, 8), np.float64)
    for b in range(B):
        idx = np.flatnonzero(valid[b])[[0, 3]]
        gt[b, :2, :7] = rois[b, idx] + rs.uniform(-0.05, 0.05, (2, 7))
        gt[b, :2, 3:6] = np.abs(gt[b, :2, 3:6]) + 0.2
        gt[b, :2, 7] = labels[b, idx]
        gt[b, 2] = [*points[b, 0, :3], 1.6, 1.6, 1.6, 0.3, 1]
    return gt


def gt_near_train_rois(model, batch):
    """``_gt_near`` the proposals of ``model``'s first stage in training mode
    in float64, run on a copy."""
    probe = copy.deepcopy(model).double().train()
    tb = _tb(batch, torch.float64)
    with torch.no_grad():
        first = SECOND.forward(probe, tb["voxels"], tb["voxel_coords"], tb["voxel_num_points"])
        props = RHT.proposal_layer(first["batch_cls_preds"], first["batch_box_preds"],
                                   probe.roi_cfg.NMS_CONFIG.TRAIN)
    return _gt_near(*(props[k].numpy() for k in ("rois", "roi_labels", "roi_valid")),
                    batch["points"])


def jax_pvrcnn(cfg):
    return j_build(JEasyDict(cfg), num_class=len(CLASSES), input_channels=4, **GEOMETRY)


def pv_jax_run(cfg_fn, backbone, batch):
    """The tiny JAX detector of ``cfg_fn(backbone, dp_ratio, score_type)`` on
    the batch: at eval in float32 (forward and the refined
    post-processing) with perturbed weights, and in training mode in
    float64 with DP_RATIO 0 and ``CLS_SCORE_TYPE`` cls (loss, gradient,
    statistics and proposals, its sampler drawing from ``FEED_KEY``), the
    gt near the training RoIs.  One compile each."""
    cfg = EasyDict(cfg_fn(backbone))
    jmodel = jax_pvrcnn(cfg_fn(backbone))
    args = _args(batch)
    variables = _perturb(jax.jit(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a))(*args), 3)

    def predict(v, *a):
        out = jmodel.apply(v, *a, train=False)
        out.pop("multi_scale_3d_features")
        return out, j_vrcnn.post_processing(out, JEasyDict(cfg))

    out, post = jax.device_get(jax.jit(predict)(variables, *args))

    cfg0 = EasyDict(cfg_fn(backbone, 0.0, "cls"))
    jmodel0 = jax_pvrcnn(cfg_fn(backbone, 0.0, "cls"))
    probe = build_network(cfg0, len(CLASSES), device="cpu", **GEOMETRY)
    load_jax_variables(probe, variables)
    gt = gt_near_train_rois(probe, batch)
    orig = JRHT.assign_targets

    def assign(rng, proposals, gt_boxes, sampler_cfg):
        t = orig(jax.random.PRNGKey(FEED_KEY), proposals, gt_boxes, sampler_cfg)
        t["_proposals"] = proposals
        return t

    with pytest.MonkeyPatch.context() as mp, _exact_f64():
        mp.setattr(JRHT, "assign_targets", assign)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        a64 = _args(batch, jnp.float64)

        # the inputs are arguments: XLA would fold a constant batch's voxel
        # centres without the fused multiply-add that it compiles otherwise
        def loss_fn(params, gt_, *a):
            o, mut = jmodel0.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                   *a, gt_boxes=gt_, train=True, mutable=["batch_stats"],
                                   rngs={"proposal": jax.random.PRNGKey(0)})
            loss, tb = jmodel0.apply(v64, o, gt_, list(CLASSES), method=jmodel0.loss)
            return loss, (tb, mut["batch_stats"], o["roi_targets"]["_proposals"])

        (loss, (tb, stats, props)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v64["params"], jnp.asarray(gt), *a64)
        f64 = dict(variables=v64, loss=float(loss), tb={k: float(x) for k, x in tb.items()},
                   grads=jax.device_get(grads), stats=jax.device_get(stats),
                   proposals=jax.device_get(props))
    model = build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY).eval()
    load_jax_variables(model, variables)
    return dict(backbone=backbone, cfg=cfg, cfg0=cfg0, variables=variables, out=out, post=post,
                gt=gt, f64=f64, model=model)


def pv_check_eval(run, batch, name):
    """The port at eval in float32 against ``run`` (:func:`pv_jax_run`): the
    keypoints equal (the FPS picks), the first-stage logits within 2e-3,
    the RoIs, labels and validity equal, each source's pooled keypoint
    features (before the fusion) and the fused ones within 1e-3, the point
    scores within 2e-3, ``rcnn_cls`` within 2e-3, the refined boxes within
    1e-3, the detections paired box for box."""
    model, want = run["model"], run["out"]
    with torch.no_grad():
        out = model.forward_batch(_tb(batch))
        post = get_post_processor(name)(out, run["cfg"])
    assert out["point_coords"].shape == (B, 32, 3)
    np.testing.assert_array_equal(out["point_coords"].numpy(), want["point_coords"])
    err = np.abs(out["cls_preds"].numpy() - want["cls_preds"]).max()
    assert err <= 2e-3, err
    for key in ("roi_labels", "roi_valid"):
        np.testing.assert_array_equal(out[key].numpy(), want[key], err_msg=key)
    np.testing.assert_allclose(out["rois"].numpy(), want["rois"], atol=1e-4, rtol=0)
    before = out["point_features_before_fusion"].numpy()
    start = 0
    for src, width in model.pfe.source_channels.items():
        part = slice(start, start + width)
        np.testing.assert_allclose(before[..., part], want["point_features_before_fusion"][
            ..., part], atol=1e-3, rtol=0, err_msg=src)
        assert np.abs(before[..., part]).max() > 0, src
        start += width
    assert start == before.shape[-1]
    for key, tol in (("point_features", 1e-3), ("point_cls_scores", 2e-3), ("rcnn_cls", 2e-3),
                     ("batch_box_preds", 1e-3)):
        err = np.abs(out[key].numpy() - want[key]).max()
        assert err <= tol, (key, err)
    post = {k: v.numpy() for k, v in post.items()}
    assert post["pred_counts"].min() > 0
    box_err, score_err = _match(post, run["post"])
    assert box_err <= 1e-3 and score_err <= 1e-4


def pv_check_float64(run, batch):
    """The port's training forward, loss and backward in float64 from the
    JAX weights, the sampler fed JAX's draws (from its proposals), against
    ``run``: the loss and its tb terms within 1e-10 relative, every gradient
    leaf within 1e-10 of its largest |gradient|, the running statistics
    within 1e-9.  The point and RCNN losses reach the 3-D backbone through
    the VSA."""
    f64, cfg0, gt = run["f64"], run["cfg0"], run["gt"]
    model = build_network(cfg0, len(CLASSES), device="cpu", **GEOMETRY).double()
    load_jax_variables(model, f64["variables"])
    model.train()
    props = {k: torch.from_numpy(np.array(v)) for k, v in f64["proposals"].items()}
    gtt = torch.from_numpy(gt)
    ok = (gtt[..., :7] != 0).any(-1)[:, None, :] & (
        props["roi_labels"][..., None] == gtt[..., 7].int()[:, None, :])
    iou = torch.where(ok, boxes_iou3d(props["rois"], gtt[..., :7]), -1.0)
    mo = torch.where(props["roi_valid"], iou.max(-1).values.clamp(min=0), 0.0)
    R = int(cfg0.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE)
    keys = jax.random.split(jax.random.PRNGKey(FEED_KEY), B)
    with _exact_f64():
        frames = [jax_sampler_draws(keys[b], mo[b].numpy(), R, np.float64) for b in range(B)]
    tb_batch = _tb(batch, torch.float64)
    tb_batch["gt_boxes"] = gtt
    out = model.forward_batch(tb_batch, draws={"sampler": _stack_draws(frames), "dropout": {}})
    loss, tb = model.loss_batch(out, tb_batch)
    loss.backward()
    assert abs(loss.item() - f64["loss"]) <= 1e-10 * abs(f64["loss"])
    assert tb["rcnn_loss_corner"] > 0 and tb["point_pos_num"] > 0
    for k, w in f64["tb"].items():
        assert abs(float(tb[k].detach()) - w) <= 1e-10 * max(abs(w), 1e-3), k
    ref = build_network(cfg0, len(CLASSES), device="cpu", **GEOMETRY).double()
    load_jax_variables(ref, {"params": f64["grads"],
                             "batch_stats": f64["variables"]["batch_stats"]})
    want = dict(ref.named_parameters())
    worst = []
    for name, p in model.named_parameters():
        scale = want[name].abs().max().item()
        if scale == 0:
            assert p.grad.abs().max().item() == 0, name
            continue
        worst.append(((p.grad - want[name]).abs().max().item() / scale, name))
    worst.sort(reverse=True)
    assert worst[0][0] <= 1e-10, f"gradients, worst first: {worst[:4]}"
    _stats_close(model, f64["stats"], atol=1e-9)
    moved = {n.split(".")[0] for n, p in model.named_parameters() if p.grad.abs().max() > 0}
    assert {"backbone_3d", "pfe", "point_head", "roi_head"} <= moved


def pv_export_equals_eager(cfg, batch, tmp_path):
    """The tiny program of ``cfg`` over seeded weights, traced by
    ``torch.export`` at the points-and-voxels spec, saved and reloaded:
    the eager closure's outputs exactly."""
    model = init_random_weights(build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY),
                                4).eval()
    dev_batch = _tb(batch)
    exported = serving.export_serving(model, cfg, dev_batch)
    path = tmp_path / "pv_b2.pt2"
    full = EasyDict(MODEL=cfg, CLASS_NAMES=list(CLASSES), DATA_CONFIG=EasyDict(
        DATA_PROCESSOR=[EasyDict(NAME="sample_points", NUM_POINTS={"train": N, "test": N}),
                        EasyDict(NAME="transform_points_to_voxels", VOXEL_SIZE=list(VOXEL_SIZE),
                                 MAX_POINTS_PER_VOXEL=P, MAX_NUMBER_OF_VOXELS=V)],
        POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z", "intensity"]}))
    meta = serving.serving_meta(full, "tiny.yaml", dev_batch, exported)
    assert list(meta["inputs"]) == ["voxels", "voxel_coords", "voxel_num_points", "points"]
    assert serving.serving_input_spec(full, B, model) == {
        k: (tuple(v.shape), v.dtype) for k, v in dev_batch.items()}
    serving.save_serving(exported, path, meta)
    predict, _ = serving.load_serving(path)
    got = predict(dev_batch)
    want = serving.make_predict_fn(model, cfg)(dev_batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module", params=BACKBONES)
def pv_run(request, batch):
    return pv_jax_run(pv_cfg, request.param, batch)


def test_pvrcnn_eval_matches_jax(batch, pv_run):
    """Eval in float32 over the dense and the sparse backbone
    (:func:`pv_check_eval`)."""
    assert type(pv_run["model"]) is PVRCNN
    pv_check_eval(pv_run, batch, "PVRCNN")


def test_pvrcnn_loss_and_gradients_match_jax_float64(batch, pv_run):
    """Training mode in float64 over the dense and the sparse backbone, JAX's
    sampler draws fed (:func:`pv_check_float64`)."""
    pv_check_float64(pv_run, batch)


def test_pvrcnn_exported_program_equals_eager(batch, tmp_path):
    """The tiny PV-RCNN program over the sparse backbone
    (:func:`pv_export_equals_eager`)."""
    pv_export_equals_eager(EasyDict(pv_cfg()), batch, tmp_path)


def test_build_network_pv_rcnn_yaml():
    """The shipped yaml at full width, its grid from the dataset: 1408 x
    1600 x 40 cells, 2048 keypoints over six sources (256 BEV channels,
    32 + 32 + 64 + 128 + 128 pooled, 640 before the fusion), 216 grid
    points into SHARED_FC; on CUDA unless told (this torch has none:
    raises); every leaf of a JAX tree of the same config consumed; the
    serving spec the voxel triplet at 40000 x 5 and the points at (1,
    16384, 4), equal to JAX's; the refined post-processing registered."""
    cfg = cfg_from_yaml_file(str(YAML))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert type(model) is PVRCNN and model.grid_size == (1408, 1600, 40)
    assert model.pfe.sources == ["bev", "raw_points", "x_conv1", "x_conv2", "x_conv3", "x_conv4"]
    assert model.pfe.fusion.in_features == 640 == model.point_head.cls_fc0.in_features
    assert model.roi_head.shared_fc0.in_features == 216 * 128
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=3, dataset=jds)
    spec = serving.serving_input_spec(cfg, 1, model)
    assert spec == {"voxels": ((1, 40000, 5, 4), torch.float32),
                    "voxel_coords": ((1, 40000, 3), torch.int32),
                    "voxel_num_points": ((1, 40000), torch.int32),
                    "points": ((1, 16384, 4), torch.float32)}
    jspec = j_serving.serving_input_spec(cfg, 1, jmodel)
    assert {k: tuple(s) for k, (s, _) in jspec.items()} == {k: s for k, (s, _) in spec.items()}
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *(jnp.zeros(s, jnp.float32 if d == torch.float32 else jnp.int32)
                                 for s, d in spec.values()), train=False))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rs.rand(*s.shape).astype(np.float32), shapes)
    load_jax_variables(model, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    torch.testing.assert_close(model.pfe.SA_x_conv3.mlps_1.layer0.dense.weight, torch.from_numpy(
        np.asarray(variables["params"]["pfe"]["SA_x_conv3"]["mlps_1"]["layer0"]["dense"]
                   ["kernel"]).T), rtol=0, atol=0)
    from pdanet_tpu_torch.models.detectors import voxel_rcnn

    assert get_post_processor("PVRCNN") is voxel_rcnn.post_processing


@pytest.mark.parametrize("yaml_name", ["PDA-SSD", "pointpillar", "second", "voxel_rcnn_car",
                                       "second_iou", "centerpoint", "pv_rcnn",
                                       "pv_rcnn_plusplus", "PartA2", "pointrcnn"])
def test_serving_input_spec_follows_device_batch_keys(yaml_name):
    """``serving_input_spec(cfg, 1, model)`` takes the detector's
    ``DEVICE_BATCH_KEYS`` (the gt keys excluded), as the JAX function
    does: the shapes equal JAX's for each shipped KITTI yaml; PV-RCNN's
    carries the points beside the voxel triplet; every other yaml's spec
    is the one of a model that declares no keys."""
    from pdanet_tpu_torch.models.detectors import __all__ as detectors

    cfg = cfg_from_yaml_file(str(REPO / "tools" / "cfgs" / "kitti_models" / f"{yaml_name}.yaml"))
    name = cfg.MODEL.NAME
    spec = serving.serving_input_spec(cfg, 1, detectors[name])  # a class attribute
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=len(cfg.CLASS_NAMES), dataset=jds)
    jspec = j_serving.serving_input_spec(cfg, 1, jmodel)
    assert {k: tuple(s) for k, (s, _) in jspec.items()} == {k: s for k, (s, _) in spec.items()}
    if name.startswith("PVRCNN"):
        assert list(spec) == ["voxels", "voxel_coords", "voxel_num_points", "points"]
    else:
        assert spec == serving.serving_input_spec(cfg, 1, None)
