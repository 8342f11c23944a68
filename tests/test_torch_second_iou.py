"""The dense voxel backbones and SECOND-IoU of pdanet_tpu_torch against the
JAX package, on the CPU, at the tiny configs of ``tests/test_second.py``
and ``tests/test_two_stage.py`` (a grid of 32 x 32 x 8 cells of 0.2 x 0.2
x 0.5 m, ``NUM_FILTERS [4, 4, 8, 8, 8]``, 16 output features), inputs from
a numpy seed (voxels in clusters at distinct cells, as the voxelizer
gives them, padded rows), weights carried from the flax variables by the
weight bridge.  The JAX side runs jitted on the CPU; its NMS takes the XLA
walk there.

* The dense ladder: a stride-2 block on an even grid equal to a torch
  ``Conv3d`` twin with pad 1 (``test_second.py:166``), the z chain 41 ->
  21 -> 11 -> 5 -> 2 (``:207``), both backbones in training and eval mode
  within 1e-5 of their largest |value| (running statistics within 1e-6),
  the float64 gradient of the masked and the unmasked ladder within
  1e-10 of its largest, and the masked dense backbone equal to the port's
  sparse one at every active site (``test_sparse_conv.py:366``).
* ``roi_grid_pool_bev`` within 1e-5 of JAX's (``test_two_stage.py:116``).
* SECOND-IoU at eval in float32: the first stage (the dense SECOND) within
  2e-3, the RoIs equal, ``rcnn_iou`` within 2e-3, the detections paired
  box for box, for each ``SCORE_TYPE``; in training mode in float64
  (``DP_RATIO`` 0, JAX's sampler draws fed, ``CLS_SCORE_TYPE`` cls): the
  loss and its tb terms (the dense SECOND's RPN terms among them) within
  1e-10 relative, every gradient leaf within 1e-10 of its largest, the
  running statistics within 1e-9 (JAX's Bessel factor is float32).
* The dropout keep masks' rate and scaling from a frame's generator; the
  tiny exported program equal to the eager closure; the shipped
  ``second_iou.yaml`` built through the dataset's geometry and filled by
  a JAX tree of the same config.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.backbones_3d import voxel_backbone as j_vb
from pdanet_tpu.models.detectors import second_iou as j_second_iou
from pdanet_tpu.models.roi_heads import roi_head_template as JRHT
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d import sparse_backbone as sb
from pdanet_tpu_torch.models.backbones_3d import voxel_backbone as vb
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.models.detectors.second import SECOND
from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT
from pdanet_tpu_torch.models.roi_heads.second_head import second_head_iou_loss
from pdanet_tpu_torch.ops.rotated_iou import boxes_iou3d
from pdanet_tpu_torch.train.train_utils import frame_generator
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_second import GRID
from test_torch_pointpillar import _match, _perturb, _stats_close
from test_torch_second import _exact_f64, clustered_coords
from test_torch_voxel_rcnn import FEED_KEY, _gt_near, _stack_draws, jax_sampler_draws
from test_two_stage import _second_iou_tiny_cfg

REPO = Path(__file__).resolve().parent.parent
YAML = REPO / "tools" / "cfgs" / "kitti_models" / "second_iou.yaml"
VOXEL = (0.2, 0.2, 0.5)
PCR = (0.0, -3.2, -3.0, 6.4, 3.2, 1.0)
CLASSES = ("Car", "Pedestrian")
GEOMETRY = dict(grid_size=GRID, voxel_size=VOXEL, point_cloud_range=PCR, class_names=CLASSES)
B, V, P = 2, 160, 5


def iou_cfg(dp_ratio=0.3, score_type="roi_iou", post_score="iou"):
    """``test_two_stage._second_iou_tiny_cfg`` (the dense backbone); the
    float64 step takes ``DP_RATIO`` 0 and ``CLS_SCORE_TYPE`` cls (the
    roi_iou labels are the RoIs' IoUs, whose float32 BEV overlap the two
    packages compute each its own way, ~1e-7 apart)."""
    cfg = copy.deepcopy(dict(_second_iou_tiny_cfg()))
    cfg["ROI_HEAD"] = copy.deepcopy(dict(cfg["ROI_HEAD"]))
    cfg["ROI_HEAD"]["DP_RATIO"] = dp_ratio
    cfg["ROI_HEAD"]["TARGET_CONFIG"] = {**cfg["ROI_HEAD"]["TARGET_CONFIG"],
                                        "CLS_SCORE_TYPE": score_type}
    cfg["POST_PROCESSING"] = copy.deepcopy(dict(cfg["POST_PROCESSING"]))
    cfg["POST_PROCESSING"]["NMS_CONFIG"] = {**cfg["POST_PROCESSING"]["NMS_CONFIG"],
                                            "SCORE_TYPE": post_score,
                                            "SCORE_WEIGHTS": {"iou": 0.6, "cls": 0.4}}
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def make_batch(seed=3, n_valid=(140, 118), grid=GRID, pcr=PCR):
    """The voxel triplet of B frames: clustered distinct cells, voxels of
    1-5 points (the rest zero) in the range, zero where padded."""
    rs = np.random.RandomState(seed)
    coords = np.stack([clustered_coords(rs, n, grid=grid, V_=V, dups=0, clusters=4)
                       for n in n_valid])
    nums = rs.randint(1, P + 1, (B, V)).astype(np.int32)
    lo, hi = np.asarray(pcr[:3]), np.asarray(pcr[3:])
    voxels = np.concatenate([rs.uniform(lo, hi, (B, V, P, 3)), rs.rand(B, V, P, 1)],
                            axis=-1).astype(np.float32)
    voxels[np.arange(P)[None, None] >= nums[..., None]] = 0
    pad = coords[..., 0] < 0
    voxels[pad], nums[pad] = 0, 0
    return {"voxels": voxels, "voxel_coords": coords, "voxel_num_points": nums}


def _tb(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if k == "voxels" else torch.from_numpy(v)
            for k, v in batch.items()}


def _args(batch, dtype=jnp.float32):
    return [jnp.asarray(batch["voxels"], dtype), jnp.asarray(batch["voxel_coords"]),
            jnp.asarray(batch["voxel_num_points"])]


@pytest.fixture(scope="module")
def batch():
    return make_batch()


# ---------------------------------------------------------------- the dense ladder

def test_dense_stride2_alignment_and_z_chain():
    """A stride-2 block at eval on an even grid (where flax SAME would
    shift every window by one) equals a torch ``Conv3d(s=2, p=1)`` + BatchNorm
    + ReLU twin, through the JAX block's variables; at the reference's z
    depth (nz 40) the levels are 41, 21, 11, 5 and conv_out 2 planes
    deep, and the BEV map carries 2 x C channels, as JAX's."""
    cin, cout, D = 3, 5, 8
    rs = np.random.RandomState(4)
    x = rs.randn(2, cin, D, D, D).astype(np.float32)
    jblock = j_vb.Conv3DBNReLU(cout, stride=(2, 2, 2))
    variables = _perturb(jblock.init(jax.random.PRNGKey(0), jnp.zeros((2, D, D, D, cin))), 1)
    block = vb.Conv3DBNReLU(cin, cout, stride=(2, 2, 2))
    load_jax_variables(block, variables)
    block.eval()
    with torch.no_grad():
        got = block(torch.from_numpy(x), None).numpy()
        conv = torch.nn.Conv3d(cin, cout, 3, stride=2, padding=1, bias=False)
        conv.weight.copy_(block.Conv_0.weight)
        bn = torch.nn.BatchNorm3d(cout, eps=1e-3).eval()
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(getattr(block.BatchNorm_0, name))
        twin = torch.relu(bn(conv(torch.from_numpy(x)))).numpy()
    want = np.asarray(jblock.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 4, 1))))
    assert got.shape == (2, cout, 4, 4, 4)
    np.testing.assert_allclose(got, twin, atol=3e-5, rtol=0)
    np.testing.assert_allclose(got, want.transpose(0, 4, 1, 2, 3), atol=3e-5, rtol=0)

    cfg = {"NUM_FILTERS": [2, 2, 3, 4, 4], "NUM_OUTPUT_FEATURES": 6}
    coords = np.stack([rs.randint(0, 40, (1, 32)), rs.randint(0, 16, (1, 32)),
                       rs.randint(0, 16, (1, 32))], axis=-1).astype(np.int32)
    port = vb.VoxelBackBone8x(cfg, 4, (16, 16, 40)).eval()
    assert port.z_chain == [41, 21, 11, 5, 2] and port.num_bev_features == 12
    with torch.no_grad():
        bev, ms = port(torch.from_numpy(rs.rand(1, 32, 4).astype(np.float32)),
                       torch.from_numpy(coords))
    assert [ms[f"x_conv{i}"].shape[1] for i in (1, 2, 3, 4)] == [41, 21, 11, 5]
    assert bev.shape == (1, 2, 2, 12)


def _dense_inputs(seed=7, shape=(16, 16, 24), n=48):
    """Distinct cells of a (nx, ny, nz) grid, the last 8 rows padded."""
    rs = np.random.RandomState(seed)
    nx, ny, nz = shape
    cells = np.stack([rs.choice(nz * ny * nx, n, replace=False) for _ in range(B)])
    coords = np.stack([cells // (ny * nx), (cells // nx) % ny, cells % nx], -1).astype(np.int32)
    coords[:, -8:] = -1
    feats = rs.randn(B, n, 4)
    feats[coords[..., 0] < 0] = 0
    return feats, coords


DENSE_CFGS = {
    "VoxelBackBone8x": {"NUM_FILTERS": [3, 3, 4, 6, 6], "NUM_OUTPUT_FEATURES": 8},
    "VoxelResBackBone8x": {"BN_MOMENTUM": 0.9},
}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", sorted(DENSE_CFGS))
def test_dense_backbone_equals_jax(name, train):
    """Float32 through the weight bridge (3-D kernels, masked BatchNorms):
    the BEV map and every level within 1e-5 of their largest |value|, the
    running statistics a training forward leaves within 1e-6."""
    feats, coords = _dense_inputs()
    feats = feats.astype(np.float32)
    cfg = DENSE_CFGS[name]
    jmod = getattr(j_vb, name)(model_cfg=cfg, input_channels=4, grid_size=(16, 16, 24))
    args = (jnp.asarray(feats), jnp.asarray(coords))
    variables = _perturb(jmod.init(jax.random.PRNGKey(0), *args), 3)
    (bev, ms), mut = jax.jit(lambda v, *a: jmod.apply(v, *a, train=train,
                                                      mutable=["batch_stats"]))(variables, *args)
    port = getattr(vb, name)(cfg, 4, (16, 16, 24))
    load_jax_variables(port, variables)
    port.train(train)
    got_bev, got_ms = port(torch.from_numpy(feats), torch.from_numpy(coords))
    assert port.num_bev_features == bev.shape[-1]
    for key, want in [("bev", bev)] + sorted(ms.items()):
        got = (got_bev if key == "bev" else got_ms[key]).detach().numpy()
        want = np.asarray(want)
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0,
                                   err_msg=key)
    assert np.abs(np.asarray(bev)).max() > 0
    if train:
        _stats_close(port, mut["batch_stats"], atol=1e-6)


@pytest.mark.parametrize("masking", [True, False])
def test_dense_backbone_float64_gradient_equals_jax(masking):
    """Training mode in float64: the BEV map within 1e-12, a weighted sum's
    gradient with respect to every parameter and to the voxel features
    within 1e-10 of its largest |value|.  With masking the port's backward
    is its own (``_MaskedBNReLU``, the active cells' values alone);
    without it (``SUBMANIFOLD_MASKING`` False, every cell in the
    statistics) it is autograd's."""
    feats, coords = _dense_inputs(seed=8)
    cfg = {"NUM_FILTERS": [3, 3, 4, 6, 6], "NUM_OUTPUT_FEATURES": 8,
           "SUBMANIFOLD_MASKING": masking}
    jmod = j_vb.VoxelBackBone8x(model_cfg=cfg, input_channels=4, grid_size=(16, 16, 24))
    with _exact_f64():
        v = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(feats.astype(np.float32)),
                               jnp.asarray(coords)), 5, np.float64)

        def f(params, x):
            (bev, _), _ = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                     jnp.asarray(coords), train=True, mutable=["batch_stats"])
            w = (jnp.arange(bev.size).reshape(bev.shape) % 7).astype(bev.dtype)
            return (bev * w).sum(), bev

        (_, bev), (g, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            v["params"], jnp.asarray(feats))
        bev, g, gx = np.asarray(bev), jax.device_get(g), np.asarray(gx)
    port = vb.VoxelBackBone8x(cfg, 4, (16, 16, 24)).double()
    load_jax_variables(port, v)
    port.train()
    x = torch.from_numpy(feats).requires_grad_()
    got, _ = port(x, torch.from_numpy(coords))
    (got * (torch.arange(got.numel(), dtype=torch.float64).reshape(got.shape) % 7)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), bev, atol=1e-12, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), gx, atol=1e-10 * np.abs(gx).max(), rtol=0)
    ref = vb.VoxelBackBone8x(cfg, 4, (16, 16, 24)).double()
    load_jax_variables(ref, {"params": g, "batch_stats": v["batch_stats"]})
    want = dict(ref.named_parameters())
    worst = max((p.grad - want[n]).abs().max().item() / want[n].abs().max().item()
                for n, p in port.named_parameters())
    assert worst <= 1e-10, worst


def test_dense_masked_backbone_equals_sparse_backbone():
    """The masked dense ``VoxelBackBone8x`` and the gather-matmul
    ``SparseVoxelBackBone8x`` of the port, two implementations of spconv's
    semantics, with the same weights and statistics at eval: the BEV maps
    equal, every level's features equal at each active site (within 1e-5
    of the largest |value|), and the dense levels zero off them."""
    feats, coords = _dense_inputs(seed=9)
    feats = torch.from_numpy(feats.astype(np.float32))
    widths, c_out = [3, 3, 4, 6, 6], 8
    dense = vb.VoxelBackBone8x({"NUM_FILTERS": widths, "NUM_OUTPUT_FEATURES": c_out}, 4,
                               (16, 16, 24))
    from pdanet_tpu_torch.models.blocks import init_random_weights

    init_random_weights(dense, seed=2).eval()
    sparse = sb.SparseVoxelBackBone8x({"NUM_FILTERS": widths, "NUM_OUTPUT_FEATURES": c_out,
                                       "ACTIVE_BUDGETS": [8 * 48] * 4}, 4, (16, 16, 24)).eval()
    state = {}
    for name, mod in dense.named_children():
        if not isinstance(mod, vb.Conv3DBNReLU):
            continue
        kernel = mod.Conv_0.weight.permute(2, 3, 4, 1, 0)  # flax's (kz, ky, kx, in, out)
        kernel = kernel.reshape(-1, *kernel.shape[-2:])
        sparse_name = name if name in ("conv_input", "conv1") or name.endswith(("_a", "_b")) \
            else None
        bn = mod.BatchNorm_0
        if sparse_name:
            state[f"{name}.kernel"] = kernel
            prefix = f"{name}.bn"
        else:
            state[f"{name}_kernel"] = kernel
            prefix = f"{name}_bn"
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            state[f"{prefix}.{leaf}"] = getattr(bn, leaf)
    sparse.load_state_dict(state, strict=True)
    with torch.no_grad():
        d_bev, d_ms = dense(feats, torch.from_numpy(coords))
        s_bev, s_ms = sparse(feats, torch.from_numpy(coords))
    scale = d_bev.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(s_bev, d_bev, atol=1e-5 * scale, rtol=0)
    for lvl in (1, 2, 3, 4):
        grid = d_ms[f"x_conv{lvl}"]  # (B, Z, Y, X, C)
        c, f, v = s_ms[f"x_conv{lvl}"]
        c, f = c[v].long(), f[v]
        b = torch.nonzero(v)[:, 0]
        at_sites = grid[b, c[:, 0], c[:, 1], c[:, 2]]
        torch.testing.assert_close(at_sites, f, atol=1e-5 * max(f.abs().max().item(), 1e-6),
                                   rtol=0)
        off = grid.clone()
        off[b, c[:, 0], c[:, 1], c[:, 2]] = 0
        assert off.abs().max().item() == 0, f"x_conv{lvl}: a value off the active sites"


# ---------------------------------------------------------------- the BEV RoI pool

def test_roi_grid_pool_bev_equals_jax():
    """``test_two_stage.py:116``'s rotated RoIs on a 24 x 20 map (some
    partly outside it): the 7 x 7 pooled patches within 1e-5 of their
    largest |value| of JAX's (the two interpolate in their own order)."""
    rs = np.random.RandomState(7)
    Bp, H, W, C, R, G = 2, 24, 20, 6, 5, 7
    feat = rs.randn(Bp, H, W, C).astype(np.float32)
    rois = np.zeros((Bp, R, 7), np.float32)
    rois[..., 0] = rs.uniform(1.0, 14.0, (Bp, R))
    rois[..., 1] = rs.uniform(-8.0, 8.0, (Bp, R))
    rois[..., 3:6] = rs.uniform(1.0, 6.0, (Bp, R, 3))
    rois[..., 6] = rs.uniform(-np.pi, np.pi, (Bp, R))
    pc_range, voxel = (0.0, -9.6, -3.0, 16.0, 9.6, 1.0), (0.1, 0.1, 0.2)
    want = np.asarray(jax.jit(lambda f, r: JRHT.roi_grid_pool_bev(f, r, G, pc_range, voxel, 8))(
        jnp.asarray(feat), jnp.asarray(rois)))
    got = RHT.roi_grid_pool_bev(torch.from_numpy(feat), torch.from_numpy(rois), G, pc_range,
                                voxel, 8)
    assert got.shape == (Bp, R, G, G, C)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)
    assert (want == 0).any() and np.abs(want).max() > 0.5  # zero padding and samples


def test_fc_stack_equals_jax():
    """``FCStack`` (two Dense + BatchNorm + ReLU layers and the biased
    output layer, JAX :315-337) in training mode: outputs within 1e-5 of
    JAX's, the running statistics within 1e-6."""
    x = np.random.RandomState(3).randn(2, 6, 10).astype(np.float32)
    jmod = JRHT.FCStack(fc_list=(8, 5), out_features=3)
    variables = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    want, mut = jax.jit(lambda v, a: jmod.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    port = RHT.FCStack(10, (8, 5), out_features=3)
    load_jax_variables(port, variables)
    got = port.train()(torch.from_numpy(x))
    assert got.shape == (2, 6, 3) and port.dropout_shapes(6) == {}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    _stats_close(port, mut["batch_stats"], atol=1e-6)


# ---------------------------------------------------------------- the detector

def jax_iou_model(cfg):
    return j_build(JEasyDict(cfg), num_class=len(CLASSES), input_channels=4, **GEOMETRY)


def gt_on_train_rois(model, batch):
    """Two gt boxes a frame on two valid RoIs of ``model``'s first stage in
    training mode in float64 (run on a copy): ``_gt_near``'s, the first of
    them moved onto its RoI exactly, so that the sample holds a foreground
    RoI (IoU above CLS_FG_THRESH) beside ignored ones."""
    probe = copy.deepcopy(model).double().train()
    with torch.no_grad():
        first = SECOND.forward(probe, *_tb(batch, torch.float64).values())
        props = RHT.proposal_layer(first["batch_cls_preds"], first["batch_box_preds"],
                                   probe.roi_cfg.NMS_CONFIG.TRAIN)
    rois, labels, valid = (props[k].numpy() for k in ("rois", "roi_labels", "roi_valid"))
    gt = _gt_near(rois, labels, valid)
    for b in range(B):
        gt[b, 0, :7] = rois[b, np.flatnonzero(valid[b])[0]]
    return gt


@pytest.fixture(scope="module")
def iou_run(batch):
    """The tiny JAX SECOND-IoU on the batch: at eval in float32 (forward and
    the post-processing of each SCORE_TYPE) with perturbed weights, and in
    training mode in float64 with DP_RATIO 0 and CLS_SCORE_TYPE cls (loss,
    gradient, the statistics the forward leaves and the proposals, its
    sampler drawing from ``FEED_KEY``), the gt near its training RoIs."""
    cfg = EasyDict(iou_cfg())
    jmodel = jax_iou_model(iou_cfg())
    args = _args(batch)
    variables = _perturb(jax.jit(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a))(*args), 3)

    def predict(v, *a):
        out = jmodel.apply(v, *a, train=False)
        out.pop("multi_scale_3d_features")
        posts = {t: j_second_iou.post_processing(out, JEasyDict(iou_cfg(post_score=t)))
                 for t in ("iou", "cls", "weighted_iou_cls")}
        return out, posts

    out, posts = jax.device_get(jax.jit(predict)(variables, *args))

    cfg0, jmodel0 = EasyDict(iou_cfg(0.0, "cls")), jax_iou_model(iou_cfg(0.0, "cls"))
    probe = build_network(cfg0, len(CLASSES), device="cpu", **GEOMETRY)
    load_jax_variables(probe, variables)
    gt = gt_on_train_rois(probe, batch)
    orig = JRHT.assign_targets

    def assign(rng, proposals, gt_boxes, sampler_cfg):
        t = orig(jax.random.PRNGKey(FEED_KEY), proposals, gt_boxes, sampler_cfg)
        t["_proposals"] = proposals
        return t

    with pytest.MonkeyPatch.context() as mp, _exact_f64():
        mp.setattr(JRHT, "assign_targets", assign)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        a64 = _args(batch, jnp.float64)

        def loss_fn(params, gt_):
            o, mut = jmodel0.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                   *a64, gt_boxes=gt_, train=True, mutable=["batch_stats"],
                                   rngs={"proposal": jax.random.PRNGKey(0)})
            loss, tb = jmodel0.apply(v64, o, gt_, list(CLASSES), method=jmodel0.loss)
            return loss, (tb, mut["batch_stats"], o["roi_targets"]["_proposals"])

        (loss, (tb, stats, props)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v64["params"], jnp.asarray(gt))
        f64 = dict(variables=v64, loss=float(loss), tb={k: float(x) for k, x in tb.items()},
                   grads=jax.device_get(grads), stats=jax.device_get(stats),
                   proposals=jax.device_get(props))
    model = build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY).eval()
    load_jax_variables(model, variables)
    return dict(cfg=cfg, cfg0=cfg0, variables=variables, out=out, posts=posts, gt=gt, f64=f64,
                model=model)


@pytest.mark.parametrize("score_type", ["iou", "cls", "weighted_iou_cls"])
def test_second_iou_eval_matches_jax(batch, iou_run, score_type):
    """Eval in float32: the first stage (the dense SECOND's logits, boxes
    and direction logits) within 2e-3, the RoIs, their labels and validity
    equal, ``rcnn_iou`` within 2e-3, the eval contract (boxes = RoIs,
    cls preds = IoU logits), and the detections of ``SCORE_TYPE`` paired
    box for box with JAX's."""
    model, want = iou_run["model"], iou_run["out"]
    with torch.no_grad():
        out = model.forward_batch(_tb(batch))
        post = get_post_processor("SECONDNetIoU")(out, EasyDict(iou_cfg(post_score=score_type)))
    assert out["rcnn_iou"].shape == (B, 16, 1) and out["batch_box_preds"].shape == (B, 16, 7)
    for key in ("cls_preds", "box_preds", "dir_cls_preds"):
        err = np.abs(out[key].numpy() - want[key]).max()
        assert err <= 2e-3, (key, err)
    for key in ("roi_labels", "roi_valid"):
        np.testing.assert_array_equal(out[key].numpy(), want[key], err_msg=key)
    np.testing.assert_allclose(out["rois"].numpy(), want["rois"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["roi_scores"].numpy(), want["roi_scores"], atol=2e-3, rtol=0)
    err = np.abs(out["rcnn_iou"].numpy() - want["rcnn_iou"]).max()
    print(f"rcnn_iou within {err:.3g}")
    assert err <= 2e-3
    assert torch.equal(out["batch_box_preds"], out["rois"])
    assert torch.equal(out["batch_cls_preds"], out["rcnn_iou"])
    post = {k: v.numpy() for k, v in post.items()}
    assert post["pred_counts"].min() > 0
    box_err, score_err = _match(post, iou_run["posts"][score_type])
    assert box_err <= 1e-3 and score_err <= 1e-4


def _f64_step(iou_run, batch, model=None):
    """The port's training forward, loss and backward in float64 from the
    JAX weights, the sampler fed JAX's draws (from its proposals)."""
    f64, cfg0, gt = iou_run["f64"], iou_run["cfg0"], iou_run["gt"]
    if model is None:
        model = build_network(cfg0, len(CLASSES), device="cpu", **GEOMETRY).double()
        load_jax_variables(model, f64["variables"])
    model.train()
    props = {k: torch.from_numpy(np.array(v)) for k, v in f64["proposals"].items()}
    gtt = torch.from_numpy(gt)
    ok = (gtt[..., :7] != 0).any(-1)[:, None, :] & (
        props["roi_labels"][..., None] == gtt[..., 7].int()[:, None, :])
    iou = torch.where(ok, boxes_iou3d(props["rois"], gtt[..., :7]), -1.0)
    mo = torch.where(props["roi_valid"], iou.max(-1).values.clamp(min=0), 0.0)
    keys = jax.random.split(jax.random.PRNGKey(FEED_KEY), B)
    with _exact_f64():
        frames = [jax_sampler_draws(keys[b], mo[b].numpy(), 16, np.float64) for b in range(B)]
    tb_batch = _tb(batch, torch.float64)
    tb_batch["gt_boxes"] = gtt
    out = model.forward_batch(tb_batch, draws={"sampler": _stack_draws(frames), "dropout": {}})
    loss, tb = model.loss_batch(out, tb_batch)
    loss.backward()
    return model, out, loss, tb


def test_second_iou_loss_and_gradients_match_jax_float64(batch, iou_run):
    """Training mode in float64 with JAX's draws fed: the loss and its tb
    terms (the dense SECOND's ``rpn_loss_*`` and ``rcnn_loss_iou``) within
    1e-10 relative, every gradient leaf within 1e-10 of its largest
    |gradient|, the running statistics within 1e-9; the IoU loss reaches
    the RoI head alone."""
    f64 = iou_run["f64"]
    model, out, loss, tb = _f64_step(iou_run, batch)
    assert abs(loss.item() - f64["loss"]) <= 1e-10 * abs(f64["loss"])
    assert tb["rpn_loss_loc"] > 0 and tb["rcnn_loss_iou"] > 0
    assert (out["roi_targets"]["rcnn_cls_labels"] > 0).any()  # foreground RoIs sampled
    for k, w in f64["tb"].items():
        assert abs(float(tb[k].detach()) - w) <= 1e-10 * max(abs(w), 1e-3), k
    ref = build_network(iou_run["cfg0"], len(CLASSES), device="cpu", **GEOMETRY).double()
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
    _stats_close(model, f64["stats"], atol=1e-9)

    model.zero_grad()
    out = model.forward_batch({**_tb(batch, torch.float64),
                               "gt_boxes": torch.from_numpy(iou_run["gt"])},
                              draws=model.train_draws([frame_generator(0, 0, b)
                                                       for b in range(B)], "cpu"))
    rcnn, _ = second_head_iou_loss(
        out["rcnn_iou"], out["roi_targets"]["rcnn_cls_labels"],
        iou_run["cfg0"].ROI_HEAD.LOSS_CONFIG)
    rcnn.backward()
    moved = {n.split(".")[0] for n, p in model.named_parameters()
             if p.grad is not None and p.grad.abs().max() > 0}
    assert moved == {"roi_head"}


def test_dropout_draws_share_scale_and_generators(iou_run):
    """``train_draws`` from a frame's own generator: keep masks after the
    first shared layer and the first IoU layer (none after the last shared
    one), kept at 1 - 0.3 of entries, the same seeds giving the same
    draws; a kept activation scaled by 1 / 0.7, a dropped one 0."""
    model = build_network(EasyDict(iou_cfg()), len(CLASSES), device="cpu", **GEOMETRY)
    gens = lambda: [frame_generator(9, 3, i) for i in range(B)]  # noqa: E731
    d1, d2 = model.train_draws(gens(), "cpu"), model.train_draws(gens(), "cpu")
    assert set(d1["dropout"]) == {"shared0", "iou0"}
    for part in ("sampler", "dropout"):
        for k in d1[part]:
            assert torch.equal(d1[part][k], d2[part][k]), k
            assert not torch.equal(d1[part][k][0], d1[part][k][1]), k
    assert d1["sampler"]["fg_perm"].shape == (B, 32)  # the TRAIN NMS_POST_MAXSIZE
    keep = d1["dropout"]["shared0"]
    assert keep.shape == (B, 16, 32) and keep.dtype == torch.bool
    assert abs(keep.float().mean().item() - 0.7) < 0.06
    net = model.roi_head.train()
    pooled = torch.randn(B, 16, 7, 7, 32)
    got = net(pooled, d1["dropout"])
    x = torch.relu(net.shared_bn0(net.shared_fc0(pooled.reshape(B, 16, -1))))
    x = torch.where(keep, x / 0.7, 0.0)
    x = torch.relu(net.shared_bn1(net.shared_fc1(x)))
    x = torch.relu(net.iou_bn0(net.iou_fc0(x)))
    x = torch.where(d1["dropout"]["iou0"], x / 0.7, 0.0)
    torch.testing.assert_close(got, net.iou_out(x), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="dropout keep masks"):
        net(pooled)


def test_second_iou_exported_program_equals_eager(batch, iou_run, tmp_path):
    """The tiny SECOND-IoU program traced by ``torch.export`` (the dense
    ladder, the proposal layer, the BEV pool), saved and reloaded, gives
    the eager closure's outputs exactly."""
    model, cfg = iou_run["model"], iou_run["cfg"]
    dev_batch = _tb(batch)
    exported = serving.export_serving(model, cfg, dev_batch)
    path = tmp_path / "second_iou_b2.pt2"
    full = EasyDict(MODEL=cfg, CLASS_NAMES=list(CLASSES), DATA_CONFIG=EasyDict(
        DATA_PROCESSOR=[EasyDict(NAME="transform_points_to_voxels", VOXEL_SIZE=list(VOXEL),
                                 MAX_POINTS_PER_VOXEL=P, MAX_NUMBER_OF_VOXELS=V)],
        POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z", "intensity"]}))
    serving.save_serving(exported, path, serving.serving_meta(full, "tiny.yaml", dev_batch,
                                                              exported))
    predict, _ = serving.load_serving(path)
    got = predict(dev_batch)
    want = serving.make_predict_fn(model, cfg)(dev_batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(want["pred_counts"].min()) > 0


def test_build_network_second_iou_yaml():
    """The shipped yaml at full width, its grid from the dataset: the dense
    ``VoxelBackBone8x`` over 41 x 1600 x 1408 cells (z chain 41, 21, 11,
    5, 2; a 256-channel BEV map), 211200 anchors, the 7 x 7 pool of 512
    channels into SHARED_FC's 25088 inputs; every leaf of a JAX tree of
    the same config consumed; SECOND-IoU's post-processing registered."""
    cfg = cfg_from_yaml_file(str(YAML))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert type(model).__name__ == "SECONDNetIoU"
    assert isinstance(model.backbone_3d, vb.VoxelBackBone8x)
    assert model.grid_size == (1408, 1600, 40) and model.anchors_flat.shape == (211200, 7)
    assert model.backbone_3d.z_chain == [41, 21, 11, 5, 2]
    assert model.backbone_3d.num_bev_features == 256
    assert model.roi_head.shared_fc0.in_features == 7 * 7 * 512
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=3, dataset=jds)
    spec = serving.serving_input_spec(cfg, 1, model)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *(jnp.zeros(s, jnp.float32 if d == torch.float32 else jnp.int32)
                                 for s, d in spec.values()), train=False))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rs.rand(*s.shape).astype(np.float32), shapes)
    assert "roi_head" in variables["params"]
    load_jax_variables(model, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    kernel = np.asarray(variables["params"]["backbone_3d"]["conv2_down"]["Conv_0"]["kernel"])
    assert kernel.shape == (3, 3, 3, 16, 32)
    torch.testing.assert_close(model.backbone_3d.conv2_down.Conv_0.weight,
                               torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2).copy()),
                               rtol=0, atol=0)
    from pdanet_tpu_torch.models.detectors import second_iou

    assert get_post_processor("SECONDNetIoU") is second_iou.post_processing
