"""The SECOND slice of pdanet_tpu_torch against the JAX package, on the CPU,
at the tiny configs of ``tests/test_sparse_conv.py`` and
``tests/test_second.py``: a 0.05 x 0.05 x 0.1 m grid of 144 x 128 x 40
cells, 256 voxels of 5 points a frame, ``NUM_FILTERS [4, 4, 8, 8, 8]``,
inputs from a numpy seed (voxels in clusters, so that the sparse convs
find neighbours, with padded rows and duplicated cells), weights carried
from the flax variables by the weight bridge.  The JAX side runs jitted
on the CPU; its sparse engine has no Pallas kernel.

* ``build_neighbor_table`` equal to JAX's: submanifold, stride 2, conv4's
  padding (0, 1, 1) and ``conv_out``'s (3, 1, 1) / (2, 1, 1) / pad 0;
  ``downsample_coords`` equal with ``dilate`` on and off, and with a
  budget that binds; ``gather_matmul_conv`` within 1e-5 (float32) and
  1e-12 (float64).
* ``MaskedBatchNorm`` in training and eval mode with padding rows poisoned
  at 1e6, its running statistics too; ``MeanVFE``.
* Both sparse backbones through the weight bridge in training mode: every
  level's coordinates equal, features and the BEV map within 1e-5 of
  their largest |value|.
* SECOND at eval in float32: logits within 2e-3 and its detections paired
  box for box with JAX's; in training mode in float64: the loss within
  1e-10 relative, every gradient leaf within 1e-10 of its largest
  |gradient|, the running statistics within 1e-9 (JAX's Bessel factor is
  float32).
* The tiny exported program equal to the eager closure; the shipped
  ``second.yaml`` built through the dataset's geometry and filled by a
  JAX tree of the same config (every leaf consumed); SECOND over the
  dynamic mean VFE and the dense ladder runs on the raw cloud, over a
  sparse backbone it raises.

Float64 on the JAX side: the JAX package's sparse conv asks XLA for a
float32 product (``preferred_element_type``), which under x64 rounds
every conv output to float32.  The float64 references here are computed
with that request dropped for float64 operands (``_exact_f64``), so that
they are float64 throughout, as the port's are (ROADMAP queue 3).
"""

import contextlib
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.backbones_3d import sparse_backbone as j_sb
from pdanet_tpu.models.backbones_3d.vfe.mean_vfe import MeanVFE as JMeanVFE
from pdanet_tpu.models.detectors.iassd import post_processing as j_post
from pdanet_tpu.ops import sparse_conv as j_sc
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d import sparse_backbone as sb
from pdanet_tpu_torch.models.backbones_3d.vfe.mean_vfe import MeanVFE
from pdanet_tpu_torch.models.detectors import __all__ as detectors
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.ops import sparse_conv as sc
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_pointpillar import PP_MODEL_CFG
from test_second import SECOND_MODEL_CFG
from test_torch_pointpillar import _flat, _match, _perturb, _stats_close

REPO = Path(__file__).resolve().parent.parent
SECOND_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "second.yaml"
GRID = (144, 128, 40)  # (nx, ny, nz): the full-res aspect at the fixture's extent
VOXEL = (0.05, 0.05, 0.1)
PCR = (0.0, -3.2, -4.0, 7.2, 3.2, 0.0)
CLASSES = ("Car", "Pedestrian")
B, V, P = 2, 256, 5
FILTERS = [4, 4, 8, 8, 8]
GEOMETRY = dict(grid_size=GRID, voxel_size=VOXEL, point_cloud_range=PCR, class_names=CLASSES)


def second_cfg(backbone="SparseVoxelBackBone8x"):
    """``tests/test_sparse_conv.py``'s SECOND over the sparse backbone, with
    PointPillar's tiny post-processing (NMS over the best 256 anchors)."""
    cfg = copy.deepcopy(dict(SECOND_MODEL_CFG))
    cfg["BACKBONE_3D"] = {"NAME": backbone, "NUM_FILTERS": FILTERS, "NUM_OUTPUT_FEATURES": 8}
    cfg["MAP_TO_BEV"] = {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 16}
    cfg["POST_PROCESSING"] = copy.deepcopy(PP_MODEL_CFG["POST_PROCESSING"])
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@contextlib.contextmanager
def _exact_f64():
    """JAX in float64, with a float32 ``preferred_element_type`` of a
    float64 product dropped (the sparse conv's ``jax.lax.dot_general``
    asks for one); every other product is as the package traces it."""
    real = jax.lax.dot_general

    def dot_general(lhs, rhs, *args, preferred_element_type=None, **kwargs):
        if jnp.result_type(lhs, rhs) == jnp.float64:
            preferred_element_type = None
        return real(lhs, rhs, *args, preferred_element_type=preferred_element_type, **kwargs)

    jax.config.update("jax_enable_x64", True)
    jax.lax.dot_general = dot_general
    try:
        yield
    finally:
        jax.lax.dot_general = real
        jax.config.update("jax_enable_x64", False)


def clustered_coords(rs, n_valid, grid=GRID, V_=V, dups=4, clusters=6):
    """(V, 3) zyx int32 sites of a (nx, ny, nz) grid: ``n_valid`` rows in
    Gaussian clusters of ~2 cells (one cluster on the grid's top corner),
    distinct but for ``dups`` rows that repeat an earlier cell, then -1
    rows; two -1 rows in the middle as well."""
    nx, ny, nz = grid
    hi = np.array([nz, ny, nx]) - 1
    centres = rs.uniform(0, hi, (clusters, 3))
    centres[0] = hi
    seen, rows = set(), []
    while len(rows) < n_valid - dups:
        c = centres[rs.randint(clusters)]
        zyx = tuple(int(v) for v in np.clip(np.round(c + rs.normal(0, [1.5, 2.5, 2.5])), 0, hi))
        if zyx not in seen:
            seen.add(zyx)
            rows.append(zyx)
    for i in rs.choice(len(rows), dups, replace=False):
        rows.insert(rs.randint(i + 1, len(rows) + 1), rows[i])
    coords = np.full((V_, 3), -1, np.int32)
    coords[:n_valid] = rows
    coords[[5, 40]] = -1
    return coords


def make_batch(seed=3, n_valid=(200, 170)):
    """The voxel triplet of B frames: clustered coords, voxels of 1-5
    points (the rest zero) in the fixture's range, zero where padded."""
    rs = np.random.RandomState(seed)
    coords = np.stack([clustered_coords(rs, n) for n in n_valid])
    nums = rs.randint(1, P + 1, (B, V)).astype(np.int32)
    lo, hi = np.asarray(PCR[:3]), np.asarray(PCR[3:])
    voxels = np.concatenate([rs.uniform(lo, hi, (B, V, P, 3)), rs.rand(B, V, P, 1)],
                            axis=-1).astype(np.float32)
    voxels[np.arange(P)[None, None] >= nums[..., None]] = 0
    pad = coords[..., 0] < 0
    voxels[pad], nums[pad] = 0, 0
    return {"voxels": voxels, "voxel_coords": coords, "voxel_num_points": nums}


def _gt():
    """Two frames of gt (M = 3): a Car and a Pedestrian in frame 0, a Car
    and a padded row in frame 1."""
    gt = np.zeros((B, 3, 8), np.float64)
    gt[0, 0] = [3.0, 0.5, -2.0, 3.9, 1.6, 1.56, 0.3, 1]
    gt[0, 1] = [5.5, -1.5, -2.4, 0.8, 0.6, 1.73, -0.4, 2]
    gt[1, 0] = [2.0, -1.0, -2.2, 3.9, 1.6, 1.56, 1.2, 1]
    return gt


def _tb(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if k == "voxels" else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def batch():
    return make_batch()


# ---------------------------------------------------------------- the engine

def _levels(coords):
    """JAX's coordinates a level, as the backbone makes them at the tiny
    grid: the stage grids, the active sites and conv4's padding."""
    grids, conv4_pad = j_sc.stage_grids(GRID)
    assert conv4_pad == (0, 1, 1) and grids[3][2] == 5  # the reference's z ladder
    sites = [jnp.asarray(coords)]
    for lvl in (1, 2, 3):
        gx, gy, gz = grids[lvl]
        sites.append(j_sc.downsample_coords(
            sites[-1], V, out_grid=(gz, gy, gx), dilate=True,
            padding=conv4_pad if lvl == 3 else (1, 1, 1)))
    return grids, conv4_pad, sites


TABLE_CASES = ("subm", "stride2", "conv4_pad011", "conv_out")


@pytest.mark.parametrize("case", TABLE_CASES)
def test_neighbor_table_equals_jax(batch, case):
    """Equal int32 slots, padded and duplicated query and support rows
    included (a duplicated cell resolves to the first of its rows in the
    stable key order), and not all absent."""
    grids, conv4_pad, sites = _levels(batch["voxel_coords"])
    args = {"subm": dict(coords=sites[0], grid_size=grids[0]),
            "stride2": dict(coords=sites[0], grid_size=grids[0], query_coords=sites[1],
                            stride=(2, 2, 2)),
            "conv4_pad011": dict(coords=sites[2], grid_size=grids[2], query_coords=sites[3],
                                 stride=(2, 2, 2), padding=conv4_pad),
            "conv_out": dict(coords=sites[3], grid_size=grids[3],
                             query_coords=j_sc.downsample_coords(
                                 sites[3], V, stride=(2, 1, 1), out_grid=(2, 16, 18),
                                 dilate=True, kernel=(3, 1, 1), padding=(0, 0, 0)),
                             stride=(2, 1, 1), kernel=(3, 1, 1), padding=(0, 0, 0))}[case]
    want = np.asarray(j_sc.build_neighbor_table(**args))
    got = sc.build_neighbor_table(**{k: torch.from_numpy(np.array(v)) if k.endswith("coords")
                                     else v for k, v in args.items()})
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    taps = (want >= 0).sum(axis=-1)
    assert taps.max() > 1, "no query found a neighbour beyond its own cell"
    if case == "subm":  # a duplicated cell: every copy finds the first row of its key
        c = batch["voxel_coords"][0]
        key = [tuple(r) for r in c]
        dup = next(i for i, k in enumerate(key) if k[0] >= 0 and key.index(k) != i)
        assert want[0, dup, 13] == want[0, key.index(key[dup]), 13] == key.index(key[dup])


@pytest.mark.parametrize("dilate,budget", [(True, V), (False, V), (True, 96), (False, 64)])
def test_downsample_coords_equals_jax(batch, dilate, budget):
    """Equal output sites, on conv2's geometry and on conv_out's (kernel
    (3, 1, 1), pad 0, clamped into its out grid), at the default budget
    and at one that binds (the first sites in scan order kept)."""
    coords = jnp.asarray(batch["voxel_coords"])
    conv2 = dict(out_grid=(21, 64, 72), padding=(1, 1, 1))
    level4 = _levels(batch["voxel_coords"])[2][3]
    for sites, kw in ((coords, conv2),
                      (level4, dict(stride=(2, 1, 1), out_grid=(2, 16, 18), kernel=(3, 1, 1),
                                    padding=(0, 0, 0)))):
        want = np.asarray(j_sc.downsample_coords(sites, budget, dilate=dilate, **kw))
        got = sc.downsample_coords(torch.from_numpy(np.array(sites)), budget,
                                   dilate=dilate, **kw)
        assert got.dtype == torch.int32 and got.shape == (B, budget, 3)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want[..., 0] >= 0).sum(axis=1).min() > 0
    n = (np.asarray(j_sc.downsample_coords(coords, budget, dilate=dilate, **conv2))[..., 0]
         >= 0).sum(axis=1)
    unbounded = (np.asarray(j_sc.downsample_coords(coords, 8 * V, dilate=dilate, **conv2))
                 [..., 0] >= 0).sum(axis=1)
    if budget < V:  # the budget binds: every slot holds a site, the first in scan order
        assert (n == budget).all() and (unbounded > budget).all()


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), (np.float64, 1e-12)])
def test_gather_matmul_conv_equals_jax(batch, dtype, atol):
    """The conv on the stride-2 table (absent taps, padded rows, a stray
    slot past V clipped), within ``atol`` of JAX's."""
    rs = np.random.RandomState(1)
    grids, _, sites = _levels(batch["voxel_coords"])
    tab = np.asarray(j_sc.build_neighbor_table(sites[0], grids[0], query_coords=sites[1],
                                               stride=(2, 2, 2)))
    tab = tab.copy()
    tab[1, 3, 0] = V + 7  # a stray slot reads its own frame's last row
    feats = rs.randn(B, V, 6).astype(dtype)
    feats[batch["voxel_coords"][..., 0] < 0] = 0
    w = (rs.randn(27, 6, 5) * 0.2).astype(dtype)
    with _exact_f64() if dtype == np.float64 else contextlib.nullcontext():
        want = np.asarray(jax.jit(j_sc.gather_matmul_conv)(jnp.asarray(feats), jnp.asarray(tab),
                                                            jnp.asarray(w)))
    assert want.dtype == dtype
    got = sc.gather_matmul_conv(torch.from_numpy(feats), torch.from_numpy(tab),
                                torch.from_numpy(w))
    assert got.dtype == torch.from_numpy(feats).dtype
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("train", [True, False])
def test_masked_batchnorm_and_mean_vfe_equal_jax(batch, train):
    """Padding rows poisoned at 1e6 touch neither the output (zero there),
    nor the statistics, nor the running averages: within 1e-5 of JAX's.
    ``MeanVFE`` within 1e-6."""
    rs = np.random.RandomState(2)
    valid = batch["voxel_coords"][..., 0] >= 0
    x = rs.randn(B, V, 6).astype(np.float32) * 2 + 0.5
    x[~valid] = 1e6
    jbn = j_sb.MaskedBatchNorm()
    variables = _perturb(jax.jit(lambda a, m: jbn.init(jax.random.PRNGKey(0), a, m))(
        jnp.asarray(x), jnp.asarray(valid)), 4)
    want, mut = jax.jit(lambda v, a, m: jbn.apply(v, a, m, train=train,
                                                  mutable=["batch_stats"]))(
        variables, jnp.asarray(x), jnp.asarray(valid))
    bn = sb.MaskedBatchNorm(6)
    load_jax_variables(bn, variables)
    bn.train(train)
    got = bn(torch.from_numpy(x), torch.from_numpy(valid))
    assert (got[torch.from_numpy(~valid)] == 0).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    _stats_close(bn, mut["batch_stats"], atol=1e-5)
    vfe = np.asarray(JMeanVFE(model_cfg={}, num_point_features=4).apply(
        {}, jnp.asarray(batch["voxels"]), jnp.asarray(batch["voxel_num_points"])))
    got = MeanVFE(None, 4)(torch.from_numpy(batch["voxels"]),
                           torch.from_numpy(batch["voxel_num_points"]))
    np.testing.assert_allclose(got.numpy(), vfe, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["SparseVoxelBackBone8x", "SparseVoxelResBackBone8x"])
def test_sparse_backbone_equals_jax(batch, name):
    """Training mode through the weight bridge (kernels of every layout,
    masked BatchNorms): every level's coordinates equal, its features and
    the BEV map within 1e-5 of their largest |value|, the running
    statistics within 1e-6."""
    widths = FILTERS if name == "SparseVoxelBackBone8x" else [4, 4, 8, 8, 16]
    mcfg = {"NAME": name, "NUM_FILTERS": widths, "NUM_OUTPUT_FEATURES": 8}
    jmod = getattr(j_sb, name)(model_cfg=JEasyDict(mcfg), input_channels=4, grid_size=GRID)
    rs = np.random.RandomState(5)
    feats = np.where(batch["voxel_coords"][..., :1] >= 0,
                     rs.randn(B, V, 4), 0).astype(np.float32)
    args = (jnp.asarray(feats), jnp.asarray(batch["voxel_coords"]))
    variables = _perturb(jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(1), *a))(*args), 6)
    (bev, multi), mut = jax.jit(lambda v, *a: jmod.apply(v, *a, train=True,
                                                         mutable=["batch_stats"]))(
        variables, *args)
    port = getattr(sb, name)(EasyDict(mcfg), 4, GRID)
    load_jax_variables(port, variables)
    assert port.num_bev_features == bev.shape[-1] == 2 * 8
    got_bev, got_multi = port.train()(torch.from_numpy(feats),
                                      torch.from_numpy(batch["voxel_coords"]))
    assert set(got_multi) == set(multi)
    for key, (c, f, v) in multi.items():
        gc, gf, gv = got_multi[key]
        np.testing.assert_array_equal(gc.numpy(), np.asarray(c), err_msg=key)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(v), err_msg=key)
        scale = np.abs(np.asarray(f)).max()
        np.testing.assert_allclose(gf.detach().numpy(), np.asarray(f), atol=1e-5 * scale,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(got_bev.detach().numpy(), np.asarray(bev),
                               atol=1e-5 * np.abs(np.asarray(bev)).max(), rtol=0)
    assert np.abs(np.asarray(bev)).max() > 0
    _stats_close(port, mut["batch_stats"], atol=1e-6)


# ---------------------------------------------------------------- the detector

def jax_second():
    """The tiny SECOND of the JAX package."""
    return j_build(JEasyDict(second_cfg()), num_class=len(CLASSES), input_channels=4,
                   **GEOMETRY)


def jax_f64_step(jmodel, variables, batch, gt):
    """JAX's training-mode forward, loss (with its tb terms) and gradient
    in float64 (``_exact_f64``) on the voxel triplet ``batch`` and ``gt``,
    one jit: ``variables`` as float64 numpy, ``loss``, ``tb``, ``grads`` and
    the ``stats`` the forward leaves."""
    with _exact_f64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        args = [jnp.asarray(batch["voxels"], jnp.float64), jnp.asarray(batch["voxel_coords"]),
                jnp.asarray(batch["voxel_num_points"])]

        def loss_fn(params, gt_):
            o, mut = jmodel.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                  *args, train=True, mutable=["batch_stats"])
            loss, tb = jmodel.apply(v64, o, gt_, list(CLASSES), method=jmodel.loss)
            return loss, (tb, mut["batch_stats"])

        (loss, (tb, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], jnp.asarray(gt))
        return dict(variables=v64, loss=float(loss), tb={k: float(x) for k, x in tb.items()},
                    grads=jax.device_get(grads), stats=jax.device_get(stats))


def jax_variables(jmodel, batch, seed=3):
    """The flax variables of ``jmodel`` at the batch's shapes, every
    statistic, scale and bias perturbed (``_perturb``), as numpy."""
    args = [jnp.asarray(batch[k]) for k in ("voxels", "voxel_coords", "voxel_num_points")]
    return _perturb(jax.jit(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a, train=False))(
        *args), seed)


@pytest.fixture(scope="module")
def second_run(batch):
    """The tiny JAX SECOND on the batch: at eval in float32 (forward and
    post-processing) with perturbed weights, and in training mode in
    float64 (loss, gradient and the statistics the forward leaves); one
    compile each, shared by the tests below."""
    cfg = EasyDict(second_cfg())
    jmodel = jax_second()
    variables = jax_variables(jmodel, batch)
    args = [jnp.asarray(batch[k]) for k in ("voxels", "voxel_coords", "voxel_num_points")]

    def predict(v, *a):
        out = jmodel.apply(v, *a, train=False)
        return out, j_post(out["batch_cls_preds"], out["batch_box_preds"], cfg.POST_PROCESSING)

    out, post = jax.device_get(jax.jit(predict)(variables, *args))
    out.pop("multi_scale_3d_features")
    f64 = jax_f64_step(jmodel, variables, batch, _gt())
    model = build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY).eval()
    load_jax_variables(model, variables)
    return dict(cfg=cfg, variables=variables, out=out, post=post, f64=f64, model=model)


def test_second_eval_matches_jax(batch, second_run):
    """Eval in float32: logits within 2e-3 (they agree far closer), boxes
    within 1e-3, and the detections paired box for box with JAX's."""
    model, want = second_run["model"], second_run["out"]
    with torch.no_grad():
        out = model.forward_batch(_tb(batch))
        post = get_post_processor("SECOND")(out, second_run["cfg"])
    A = 18 * 16 * 4
    assert out["batch_cls_preds"].shape == (B, A, 2)
    err = np.abs(out["batch_cls_preds"].numpy() - want["batch_cls_preds"]).max()
    print(f"logits within {err:.3g}")
    assert err <= 2e-3
    for key in ("cls_preds", "box_preds", "dir_cls_preds", "batch_box_preds"):
        np.testing.assert_allclose(out[key].numpy(), want[key], atol=1e-3, rtol=0, err_msg=key)
    post = {k: v.numpy() for k, v in post.items()}
    assert post["pred_counts"].min() > 0
    box_err, score_err = _match(post, second_run["post"])
    print(f"detections paired: max box diff {box_err:.3g} m, max score diff {score_err:.3g}")
    assert box_err <= 1e-3 and score_err <= 1e-4


def test_second_loss_and_gradients_match_jax_float64(batch, second_run):
    """Training mode in float64: the loss and its tb terms within 1e-10
    relative, every gradient leaf within 1e-10 of its largest |gradient|
    (the sparse kernels' included), and the masked BatchNorms' updated
    running statistics within 1e-9: the JAX package counts the valid rows
    in float32 (``valid.astype(jnp.float32)``), so its Bessel factor n / (n
    - 1) carries float32's rounding into the running variance (3e-10 here),
    where the port's count follows the dtype of x."""
    f64, cfg = second_run["f64"], second_run["cfg"]
    model = build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY).double()
    load_jax_variables(model, f64["variables"])
    model.train()
    tb_batch = _tb(batch, torch.float64)
    tb_batch["gt_boxes"] = torch.from_numpy(_gt())
    loss, tb = model.loss_batch(model.forward_batch(tb_batch), tb_batch)
    loss.backward()
    assert abs(loss.item() - f64["loss"]) <= 1e-10 * abs(f64["loss"])
    assert tb["rpn_loss_loc"] > 0  # the gt has positives
    for k, w in f64["tb"].items():
        assert abs(float(tb[k].detach()) - w) <= 1e-10 * max(abs(w), 1e-3), k
    ref = build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY).double()
    load_jax_variables(ref, {"params": f64["grads"],
                             "batch_stats": f64["variables"]["batch_stats"]})
    want = dict(ref.named_parameters())
    worst = []
    for name, p in model.named_parameters():
        scale = want[name].abs().max().item()
        assert scale > 0, f"{name}: no gradient in JAX"
        worst.append(((p.grad - want[name]).abs().max().item() / scale, name))
    worst.sort(reverse=True)
    assert worst[0][0] <= 1e-10, f"gradients, worst first: {worst[:4]}"
    assert any("kernel" in n for _, n in worst)
    _stats_close(model, f64["stats"], atol=1e-9)


def test_second_exported_program_equals_eager(batch, second_run, tmp_path):
    """The tiny SECOND program traced by ``torch.export`` (no ``unique`` or
    ``nonzero`` in it), saved and reloaded, gives the eager closure's
    outputs exactly; the serve CLI, which reads point clouds, refuses it,
    as the JAX package's does."""
    model, cfg = second_run["model"], second_run["cfg"]
    dev_batch = _tb(batch)
    exported = serving.export_serving(model, cfg, dev_batch)
    names = {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}
    assert any("searchsorted" in n for n in names) and not any(
        "unique" in n or "nonzero" in n for n in names)
    path = tmp_path / "second_b2.pt2"
    full = EasyDict(MODEL=cfg, CLASS_NAMES=list(CLASSES), DATA_CONFIG=EasyDict(
        DATA_PROCESSOR=[EasyDict(NAME="transform_points_to_voxels", VOXEL_SIZE=list(VOXEL),
                                 MAX_POINTS_PER_VOXEL=P, MAX_NUMBER_OF_VOXELS=V)],
        POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z", "intensity"]}))
    assert serving.serving_input_spec(full, B, model) == {
        k: (tuple(v.shape), v.dtype) for k, v in dev_batch.items()}
    serving.save_serving(exported, path, serving.serving_meta(full, "tiny.yaml", dev_batch,
                                                              exported))
    predict, _ = serving.load_serving(path)
    got = predict(dev_batch)
    want = serving.make_predict_fn(model, cfg)(dev_batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(want["pred_counts"].min()) > 0
    from pdanet_tpu_torch.tools import serve as serve_cli

    with pytest.raises(SystemExit, match="point detector's program only"):
        serve_cli.main(["--artifact", str(path), "--inputs", str(tmp_path / "*.bin")])


def test_build_network_second_yaml_and_unported_raise():
    """The shipped yaml at full width, its grid from the dataset (1408 x
    1600 x 40 cells, 211200 anchors, a 256-channel BEV map), every leaf of
    a JAX tree of the same config consumed; the serving example's voxels
    are distinct cells in clusters, PointPillar's drawn as before; SECOND
    over the dynamic mean VFE builds and runs on the dense ladder, its grid
    equal to JAX's (occupied cells equal, means within 1e-6), and raises
    over the sparse one."""
    cfg = cfg_from_yaml_file(str(SECOND_YAML))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert model.grid_size == (1408, 1600, 40) and model.anchors_flat.shape == (211200, 7)
    assert model.backbone_3d.num_bev_features == 256
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=3, dataset=jds)
    spec = serving.serving_input_spec(cfg, 1, model)
    assert spec["voxels"][0] == (1, 40000, 5, 4)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *(jnp.zeros(s, jnp.float32 if d == torch.float32 else jnp.int32)
                                 for s, d in spec.values()), train=False))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rs.rand(*s.shape).astype(np.float32), shapes)
    load_jax_variables(model, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    assert model.backbone_3d.conv2_down_kernel.shape == (27, 16, 32)
    torch.testing.assert_close(model.backbone_3d.conv_out_kernel, torch.from_numpy(
        np.asarray(variables["params"]["backbone_3d"]["conv_out_kernel"])), rtol=0, atol=0)
    tensors = [*model.named_parameters(), *model.named_buffers()]
    assert [n for n, t in tensors if not t.is_contiguous()] == []

    # the serving example on the 90 M-cell grid: distinct, clustered cells
    example = serving.example_device_batch(cfg, serving.serving_input_spec(cfg, 1, model), "cpu")
    coords = example["voxel_coords"]
    assert len(np.unique(coords[0].numpy(), axis=0)) == 40000 and (coords >= 0).all()
    grids, _ = sc.stage_grids(model.grid_size)
    tab = sc.build_neighbor_table(coords, grids[0])
    assert ((tab >= 0).sum(dim=-1) > 1).float().mean() > 0.5
    pp_cfg = cfg_from_yaml_file(str(REPO / "tools" / "cfgs" / "kitti_models" / "pointpillar.yaml"))
    pp_spec = serving.serving_input_spec(pp_cfg, 2, detectors["PointPillar"])  # the class's keys
    pp = serving.example_device_batch(pp_cfg, pp_spec, "cpu", seed=4)["voxel_coords"].numpy()
    rs = np.random.RandomState(4)
    rs.uniform(size=(2, 40000, 32, 3))  # the voxels' draw comes first
    cells = np.stack([rs.choice(432 * 496, 40000, replace=False) for _ in range(2)])
    np.testing.assert_array_equal(pp[..., 1] * 432 + pp[..., 2], cells)

    # the dynamic VFE over the dense ladder, as the JAX package builds it,
    # equals JAX's on the CPU (tests/test_torch_dynamic_vfe.py); the sparse
    # engine takes a voxel list, which the dynamic VFE does not give
    dense = EasyDict(second_cfg("VoxelBackBone8x"))
    dense.VFE = EasyDict({"NAME": "DynamicMeanVFE"})
    model = build_network(dense, 2, device="cpu", **GEOMETRY)
    assert model.DEVICE_BATCH_KEYS == ("points", "gt_boxes")
    from pdanet_tpu.models.backbones_3d.vfe.dynamic_mean_vfe import DynamicMeanVFE as JVFE

    rs = np.random.RandomState(1)
    pts = np.concatenate([rs.uniform(PCR[:3], PCR[3:], (2, 500, 3)), rs.rand(2, 500, 1)],
                         -1).astype(np.float32)
    with torch.no_grad():
        grid = model.vfe(torch.from_numpy(pts)).numpy()
        out = model.eval().forward_batch({"points": torch.from_numpy(pts)})
    jvfe = JVFE(model_cfg={}, num_point_features=4, **{k: GEOMETRY[k] for k in (
        "grid_size", "voxel_size", "point_cloud_range")})
    want = np.asarray(jax.jit(lambda p: jvfe.apply({}, p))(pts))
    np.testing.assert_array_equal((grid != 0).any(-1), (want != 0).any(-1))
    np.testing.assert_allclose(grid, want, rtol=1e-6, atol=1e-6)
    assert out["batch_box_preds"].shape == (2, model.anchors_flat.shape[0], 7)
    assert torch.isfinite(out["batch_box_preds"]).all()
    sparse = EasyDict(second_cfg())
    sparse.VFE = EasyDict({"NAME": "DynamicMeanVFE"})
    with pytest.raises(ValueError, match="dense grid"):
        build_network(sparse, 2, device="cpu", **GEOMETRY)


def test_jax_tree_and_port_state_flat_names(second_run):
    """Every flax leaf of the tiny SECOND names its port tensor: the
    kernels of the sparse convs keep flax's names and layout."""
    flat = _flat(second_run["variables"]["params"])
    state = second_run["model"].state_dict()
    for key, arr in flat.items():
        if "kernel" in key.split("/")[-1] and key.startswith("backbone_3d/"):
            port = state[key.replace("/", ".")]
            np.testing.assert_array_equal(port.numpy(), np.asarray(arr), err_msg=key)
