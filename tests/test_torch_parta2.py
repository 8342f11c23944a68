"""The Part-A2 slice of pdanet_tpu_torch against the JAX package, on the
CPU, at ``tests/test_parta2.py``'s tiny config (``PARTA2_MODEL_CFG``: a
32 x 32 x 8 grid of 0.2 x 0.2 x 0.5 m cells, whose conv4 takes z padding 0)
with its RoI head cut to a 4^3 pool: inputs from a numpy seed (voxels in
clusters of distinct cells, padded rows), weights carried from the flax
variables by the weight bridge.

* ``build_inverse_neighbor_table`` equal to JAX's (conv4's z padding 0,
  fine sites below the coarse lattice's first tap); the sparse inverse conv
  equal to the transposed conv's defining sum (mirrors
  ``test_sparse_unet.py:39``) within 1e-5;
* ``SparseUNetV2`` and ``UNetV2`` in training mode in float32: the
  decoder's voxel features, the BEV map and the running statistics within
  1e-5 of their largest |value|; in float64 the features within 1e-12 and
  every gradient leaf of a random projection within 1e-10 of its largest
  |gradient|; the dense UNet equal to the sparse one at the active sites
  (1e-4, mirrors ``test_sparse_unet.py:166``, through the JAX package's
  checkpoint converter);
* ``roiaware_pool3d`` max and avg equal to JAX's (float32, within 1e-6);
  float64 gradients on features with ReLU-zero ties within 1e-12;
* ``PointResidualCoder`` encode and decode within 1e-6;
  ``intra_part_labels`` and both point-head losses within 1e-6 (float32)
  and 1e-12 (float64);
* ``PartA2HeadNet`` at eval and in training, JAX's dropout masks fed:
  outputs within 1e-5 (2e-3 for the logits of the full three-layer
  stacks' float32 sums), statistics within 1e-5 relative;
* ``PartA2Net`` over the sparse UNet at eval in float32 (the RoIs equal,
  logits within 2e-3, detections paired box for box) and in training mode
  in float64 (JAX's sampler draws fed, ``DP_RATIO`` 0, ``CLS_SCORE_TYPE``
  cls: loss within 1e-10 relative, gradients within 1e-10 of each leaf's
  scale, statistics within 1e-9).

Float64 on the JAX side drops the sparse conv's float32
``preferred_element_type`` (``test_torch_second._exact_f64``).
"""

import contextlib
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from pdanet_tpu.models.backbones_3d.sparse_unet import SparseUNetV2 as JSparseUNetV2
from pdanet_tpu.models.backbones_3d.voxel_unet import UNetV2 as JUNetV2
from pdanet_tpu.models.dense_heads import point_head_box as j_phb
from pdanet_tpu.models.dense_heads import point_intra_part_head as j_pih
from pdanet_tpu.models.detectors import voxel_rcnn as j_vrcnn
from pdanet_tpu.models.roi_heads import partA2_head as j_pa2
from pdanet_tpu.models.roi_heads import roi_head_template as JRHT
from pdanet_tpu.ops import roi_pool as j_rp
from pdanet_tpu.ops import sparse_conv as j_sc
from pdanet_tpu.utils.box_coder_utils import PointResidualCoder as JPointResidualCoder
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.blocks import init_random_weights
from pdanet_tpu_torch.models.backbones_3d.sparse_unet import SparseUNetV2
from pdanet_tpu_torch.models.backbones_3d.voxel_unet import UNetV2
from pdanet_tpu_torch.models.dense_heads import point_head_box as phb
from pdanet_tpu_torch.models.dense_heads import point_intra_part_head as pih
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT
from pdanet_tpu_torch.models.roi_heads.partA2_head import PartA2HeadNet
from pdanet_tpu_torch.ops import roi_pool as rp
from pdanet_tpu_torch.ops import sparse_conv as sc
from pdanet_tpu_torch.ops.rotated_iou import boxes_iou3d
from pdanet_tpu_torch.utils.box_coder_utils import PointResidualCoder
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_parta2 import GRID, PARTA2_MODEL_CFG, PC_RANGE, VOXEL_SIZE
from test_torch_pointpillar import _match, _perturb, _stats_close
from test_torch_second import _exact_f64, clustered_coords
from test_torch_voxel_rcnn import FEED_KEY, _stack_draws, jax_sampler_draws

REPO = Path(__file__).resolve().parent.parent
CLASSES = ("Car", "Pedestrian")
GEOMETRY = dict(grid_size=GRID, voxel_size=VOXEL_SIZE, point_cloud_range=PC_RANGE,
                class_names=CLASSES)
B, V, P = 2, 160, 5
MEAN_SIZES = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73]]


def parta2_cfg(backbone="SparseUNetV2", dp_ratio=0.3, score_type="roi_iou"):
    """``test_parta2.PARTA2_MODEL_CFG`` over ``backbone``.  The float64 step
    takes ``CLS_SCORE_TYPE`` cls and ``DP_RATIO`` 0, as for Voxel-RCNN
    (``test_torch_voxel_rcnn.vrcnn_cfg``)."""
    cfg = copy.deepcopy(PARTA2_MODEL_CFG)
    cfg["BACKBONE_3D"] = {"NAME": backbone}
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
    """The voxel triplet of B frames on the tiny grid: clustered distinct
    cells (the dense UNet wants them distinct), padded rows, voxels of 1-5
    points in the range, zero where padded."""
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
    return {"voxels": voxels, "voxel_coords": coords, "voxel_num_points": nums}


def _tb(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if k == "voxels" else torch.from_numpy(v)
            for k, v in batch.items()}


def _args(batch, dtype=jnp.float32):
    return [jnp.asarray(batch["voxels"], dtype), jnp.asarray(batch["voxel_coords"]),
            jnp.asarray(batch["voxel_num_points"])]


def _gap(got, want):
    """The largest |got - want| over the largest |want|."""
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------- the sparse engine

@pytest.mark.parametrize("padding", [None, (0, 1, 1)])
def test_inverse_neighbor_table_equals_jax(padding):
    """The inverse table of a stride-2 conv from the coarse sites back to
    the fine ones, at the default padding and conv4's (0, 1, 1) (the taps
    shifted up by one in z): slots equal to JAX's, -1 included; fine sites
    on the lattice's first row (where q - offset is negative) find none
    below it."""
    rs = np.random.RandomState(0)
    fine_grid = (12, 10, 7)
    coarse_grid = tuple((g + 1) // 2 for g in fine_grid)
    fine = np.stack([clustered_coords(rs, 60, grid=fine_grid, V_=72, dups=0, clusters=3)
                     for _ in range(B)])
    fine[0, 0] = (0, 0, 0)
    coarse = j_sc.downsample_coords(jnp.asarray(fine), 48, out_grid=coarse_grid[::-1],
                                    dilate=True, padding=padding or (1, 1, 1))
    coarse = np.asarray(coarse)
    want = np.asarray(j_sc.build_inverse_neighbor_table(
        jnp.asarray(coarse), coarse_grid, jnp.asarray(fine), padding=padding))
    got = sc.build_inverse_neighbor_table(torch.from_numpy(coarse), coarse_grid,
                                          torch.from_numpy(fine), padding=padding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 100 and (want[fine[..., 0] < 0] == -1).all()


def test_inverse_conv_matches_transposed_oracle():
    """output(q) = sum over taps of w[tap] x((q - tap) / 2) where the
    division is exact: the stride-2 transposed conv restricted to the
    active sites (``test_sparse_unet.py:39``), through the port's table and
    ``gather_matmul_conv``, within 1e-5."""
    rs = np.random.RandomState(0)
    grid_fine = (10, 8, 6)
    grid_coarse = tuple((g + 1) // 2 for g in grid_fine)
    Vf, Vc, C_in, C_out = 48, 24, 5, 4

    def unique(grid, n_pad, Vn):
        nx, ny, nz = grid
        coords = np.full((B, Vn, 3), -1, np.int32)
        for b in range(B):
            cells = rs.permutation(nx * ny * nz)[:Vn - n_pad - b]
            coords[b, :len(cells)] = np.stack([cells // (ny * nx), (cells // nx) % ny,
                                               cells % nx], -1)
        return coords

    fine, coarse = unique(grid_fine, 8, Vf), unique(grid_coarse, 4, Vc)
    feats = rs.randn(B, Vc, C_in).astype(np.float32)
    feats[coarse[..., 0] < 0] = 0
    w = (rs.randn(27, C_in, C_out) * 0.1).astype(np.float32)
    tab = sc.build_inverse_neighbor_table(torch.from_numpy(coarse), grid_coarse,
                                          torch.from_numpy(fine))
    got = sc.gather_matmul_conv(torch.from_numpy(feats), tab, torch.from_numpy(w)).numpy()
    offs = [(oz, oy, ox) for oz in (-1, 0, 1) for oy in (-1, 0, 1) for ox in (-1, 0, 1)]
    lut = {(b, *coarse[b, v]): v for b in range(B) for v in range(Vc) if coarse[b, v, 0] >= 0}
    want = np.zeros((B, Vf, C_out), np.float32)
    for b in range(B):
        for q in range(Vf):
            if fine[b, q, 0] < 0:
                continue
            for k, off in enumerate(offs):
                t = fine[b, q] - np.array(off)
                if np.any(t % 2) or np.any(t < 0):
                    continue
                src = lut.get((b, *(t // 2)))
                if src is not None:
                    want[b, q] += feats[b, src] @ w[k]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.abs(want).max() > 0


# ---------------------------------------------------------------- the UNets

UNETS = {"SparseUNetV2": (JSparseUNetV2, SparseUNetV2), "UNetV2": (JUNetV2, UNetV2)}


def _unet_inputs(seed=1):
    batch = make_batch(seed)
    rs = np.random.RandomState(seed)
    feats = rs.rand(B, V, 4).astype(np.float32)
    feats[batch["voxel_coords"][..., 0] < 0] = 0
    return feats, batch["voxel_coords"]


@pytest.mark.parametrize("name", list(UNETS))
def test_unet_equals_jax_float32(name):
    """Training mode in float32 (the encoded BEV map on): the decoder's
    voxel features, their validity, the BEV map and the running statistics
    within 1e-5 of their largest |value|; at eval the features within 1e-5
    as well."""
    jcls, cls = UNETS[name]
    feats, coords = _unet_inputs()
    jnet = jcls(model_cfg={}, input_channels=4, grid_size=GRID)
    args = (jnp.asarray(feats), jnp.asarray(coords))
    variables = _perturb(jnet.init(jax.random.PRNGKey(0), *args), 2)
    (bev_w, aux_w), mut = jax.jit(lambda v: jnet.apply(v, *args, train=True,
                                                       mutable=["batch_stats"]))(variables)
    net = cls({}, 4, GRID)
    load_jax_variables(net, variables)
    net.train()
    bev, aux = net(torch.from_numpy(feats), torch.from_numpy(coords))
    np.testing.assert_array_equal(aux["point_valid"].numpy(), np.asarray(aux_w["point_valid"]))
    assert _gap(aux["point_features"].detach(), aux_w["point_features"]) <= 1e-5
    assert _gap(bev.detach(), bev_w) <= 1e-5
    got = dict(net.named_buffers())
    for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(mut["batch_stats"]))[0]:
        *mods, leaf = [p.key for p in path]
        key = ".".join(mods + [{"mean": "running_mean", "var": "running_var"}[leaf]])
        assert _gap(got[key], v) <= 1e-5, key
    net.eval()
    load_jax_variables(net, variables)
    with torch.no_grad():
        _, aux = net(torch.from_numpy(feats), torch.from_numpy(coords))
    _, aux_w = jax.jit(lambda v: jnet.apply(v, *args))(variables)
    assert _gap(aux["point_features"], aux_w["point_features"]) <= 1e-5
    pv = np.asarray(aux_w["point_valid"])
    assert (aux["point_features"].numpy()[~pv] == 0).all() and pv.sum() < pv.size


@pytest.mark.parametrize("name", list(UNETS))
def test_unet_equals_jax_float64(name):
    """Training mode in float64, without the encoded tensor (Part-A2-free):
    the decoder's features within 1e-12 of their largest |value| and the
    gradients of a random projection of them within 1e-10 of each leaf's
    largest |gradient|."""
    jcls, cls = UNETS[name]
    feats, coords = _unet_inputs(2)
    proj = np.random.RandomState(4).randn(B, V, 16)
    cfg = {"RETURN_ENCODED_TENSOR": False}
    jnet = jcls(model_cfg=cfg, input_channels=4, grid_size=GRID)
    variables = _perturb(jnet.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                                   jnp.asarray(coords)), 3, np.float64)
    with _exact_f64():
        v64 = jax.tree_util.tree_map(jnp.asarray, variables)

        def loss_fn(params, f, c):
            (bev, aux), _ = jnet.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                       f, c, train=True, mutable=["batch_stats"])
            assert bev is None
            return (aux["point_features"] * proj).sum(), aux["point_features"]

        (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], jnp.asarray(feats, jnp.float64), jnp.asarray(coords))
        want, grads = np.asarray(want), jax.device_get(grads)
    net = cls(cfg, 4, GRID).double()
    load_jax_variables(net, variables)
    net.train()
    bev, aux = net(torch.from_numpy(feats).double(), torch.from_numpy(coords))
    assert bev is None and not hasattr(net, "conv_out") and not hasattr(net, "conv_out_kernel")
    assert _gap(aux["point_features"].detach(), want) <= 1e-12
    (aux["point_features"] * torch.from_numpy(proj)).sum().backward()
    ref = cls(cfg, 4, GRID).double()
    load_jax_variables(ref, {"params": grads, "batch_stats": variables["batch_stats"]})
    want_g = dict(ref.named_parameters())
    worst = max((_gap(p.grad, want_g[n].detach()), n) for n, p in net.named_parameters())
    assert worst[0] <= 1e-10, worst


def test_dense_unet_equals_sparse_at_active_sites():
    """The dense UNetV2's variables carried onto the sparse one through the
    JAX package's checkpoint converter (the reference's spconv schema and
    back, ``test_sparse_unet.py:166``), both ports at eval: the BEV maps
    and the decoder's features at the active sites within 1e-4."""
    sys.path.insert(0, str(REPO / "tools"))
    from ckpt_converter import TorchTree, convert_sparse_unet
    from test_converter_two_stage import _emit_dense_unet

    rs = np.random.RandomState(13)
    nx, ny, nz = 16, 16, 24
    Vd = 40
    cells = rs.choice(nz * ny * nx, Vd, replace=False)
    coords = np.stack([cells // (ny * nx), (cells // nx) % ny, cells % nx], -1)[None].astype(
        np.int32)
    feats = rs.randn(1, Vd, 4).astype(np.float32)
    dvars = jax.tree_util.tree_map(np.asarray, dict(JUNetV2(
        model_cfg={}, input_channels=4, grid_size=(nx, ny, nz)).init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(coords))))
    dvars = _perturb(dvars, 5)
    sd = {}
    _emit_dense_unet(sd, "bb", dvars["params"], dvars["batch_stats"])
    sp, ss = convert_sparse_unet(TorchTree(sd).sub("bb"), input_channels=4)
    dense = UNetV2({}, 4, (nx, ny, nz)).eval()
    load_jax_variables(dense, dvars)
    sparse = SparseUNetV2({"ACTIVE_BUDGETS": [8 * Vd] * 4}, 4, (nx, ny, nz)).eval()
    load_jax_variables(sparse, {"params": sp, "batch_stats": ss})
    with torch.no_grad():
        d_bev, d_aux = dense(torch.from_numpy(feats), torch.from_numpy(coords))
        s_bev, s_aux = sparse(torch.from_numpy(feats), torch.from_numpy(coords))
    np.testing.assert_allclose(s_bev.numpy(), d_bev.numpy(), rtol=1e-4, atol=1e-4)
    dv = d_aux["point_valid"].numpy()
    np.testing.assert_array_equal(s_aux["point_valid"].numpy(), dv)
    np.testing.assert_allclose(s_aux["point_features"].numpy()[dv],
                               d_aux["point_features"].numpy()[dv], rtol=1e-4, atol=1e-4)
    assert np.abs(d_aux["point_features"].numpy()).max() > 0.1


# ---------------------------------------------------------------- the RoI-aware pool

def _pool_inputs(seed, dtype):
    """Two frames of 300 points, half inside four boxes (three RoIs on them,
    one elsewhere), ReLU'd features with many zeros (ties), padded points."""
    rs = np.random.RandomState(seed)
    rois = np.array([[1.0, 0.5, -0.5, 2.0, 1.2, 1.0, 0.4], [3.0, -1.0, 0.0, 1.0, 1.0, 1.5, -1.2],
                     [2.0, 1.5, -0.2, 3.0, 1.5, 1.2, 2.8], [5.0, 2.0, 0.0, 0.6, 0.6, 0.6, 0.0]])
    rois = np.stack([rois, rois[::-1] + 0.1])
    pts = np.concatenate([rois[:, :3, None, :3] + rs.uniform(-0.7, 0.7, (B, 3, 50, 3)),
                          rs.uniform(-1, 6, (B, 3, 50, 3))], axis=1).reshape(B, 300, 3)
    feats = np.maximum(rs.randn(B, 300, 5), 0.0)
    valid = rs.rand(B, 300) < 0.9
    return [a.astype(dtype) for a in (rois, pts, feats)] + [valid]


@pytest.mark.parametrize("method", ["max", "avg"])
def test_roiaware_pool3d_equals_jax(method):
    """Each frame's RoIs over its points into a 3 x 4 x 2 grid: the pooled
    values within 1e-6 of JAX's (vmapped over the frames), cells empty and
    full."""
    rois, pts, feats, valid = _pool_inputs(0, np.float32)
    out = (3, 4, 2)
    want = np.asarray(jax.vmap(lambda r, p, f, v: j_rp.roiaware_pool3d(
        r, p, f, out, pool_method=method, point_valid=v))(
        *(jnp.asarray(a) for a in (rois, pts, feats, valid))))
    got = rp.roiaware_pool3d(*(torch.from_numpy(a) for a in (rois, pts, feats)), out, method,
                             torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    occupied = np.abs(want).sum(-1) > 0
    assert 0.2 < occupied.mean() < 1.0


@pytest.mark.parametrize("method", ["max", "avg"])
def test_roiaware_pool3d_gradients_equal_jax_float64(method):
    """The float64 gradient of a random projection of the pooled grid with
    respect to the features, ReLU'd with zeros tied in the max cells:
    within 1e-12 of JAX's (a tie's gradient split evenly on both)."""
    rois, pts, feats, valid = _pool_inputs(1, np.float64)
    out = (3, 4, 2)
    proj = np.random.RandomState(2).randn(B, 4, *out, 5)
    with _exact_f64():
        def f(x):
            pooled = jax.vmap(lambda r, p, f_, v: j_rp.roiaware_pool3d(
                r, p, f_, out, pool_method=method, point_valid=v))(
                jnp.asarray(rois), jnp.asarray(pts), x, jnp.asarray(valid))
            return (pooled * proj).sum()

        want = np.asarray(jax.grad(f)(jnp.asarray(feats)))
    x = torch.from_numpy(feats).requires_grad_()
    (rp.roiaware_pool3d(torch.from_numpy(rois), torch.from_numpy(pts), x, out, method,
                        torch.from_numpy(valid)) * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-12, rtol=0)
    assert np.abs(want).max() > 0 and (feats == 0).mean() > 0.3


# ---------------------------------------------------------------- the point heads

def test_point_residual_coder_equals_jax():
    """Encode (extents at 1e-5, classes out of range clamped) and decode
    with the mean sizes, and without: within 1e-6 of JAX's."""
    rs = np.random.RandomState(4)
    gt = np.concatenate([rs.uniform(-5, 5, (40, 3)), rs.uniform(0, 4, (40, 3)),
                         rs.uniform(-3, 3, (40, 1))], -1).astype(np.float32)
    gt[0, 3] = 0.0
    pts = rs.uniform(-5, 5, (40, 3)).astype(np.float32)
    cls = rs.randint(0, 4, 40).astype(np.int32)
    codes = rs.randn(40, 8).astype(np.float32) * 0.3
    for kw in ({"use_mean_size": True, "mean_size": MEAN_SIZES}, {"use_mean_size": False}):
        jc, c = JPointResidualCoder(**kw), PointResidualCoder(**kw)
        t = lambda a: torch.from_numpy(a)  # noqa: E731
        np.testing.assert_allclose(c.encode(t(gt), t(pts), t(cls)).numpy(), np.asarray(
            jc.encode(jnp.asarray(gt), jnp.asarray(pts), jnp.asarray(cls))), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(c.decode(t(codes), t(pts), t(cls)).numpy(), np.asarray(
            jc.decode(jnp.asarray(codes), jnp.asarray(pts), jnp.asarray(cls))), atol=1e-6,
            rtol=1e-6)


def _head_inputs(seed, dtype):
    """Points in, beside and outside two gt boxes a frame (a padded gt row),
    padded rows, logits of 2 classes, part logits and box codes."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((B, 3, 8), np.float64)
    gt[:, 0] = [3.0, 0.5, -0.8, 3.9, 1.6, 1.56, 0.3, 1]
    gt[:, 1] = [1.5, -1.0, -0.2, 0.8, 0.6, 1.73, -0.5, 2]
    pts = np.concatenate([gt[:, :2, None, :3] + rs.uniform(-1.2, 1.2, (B, 2, 24, 3)),
                          rs.uniform(-3, 5, (B, 1, 24, 3))], axis=1).reshape(B, 72, 3)
    valid = rs.rand(B, 72) < 0.9
    arrays = (rs.randn(B, 72, 2), rs.randn(B, 72, 3), rs.randn(B, 72, 8) * 0.3, pts, gt)
    return [a.astype(dtype) for a in arrays] + [valid]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_point_losses_equal_jax(dtype):
    """``intra_part_labels`` within 1e-6 (a point on a box face at 1 / 0.5 /
    0.5, ``test_parta2.py``'s oracle); ``point_intra_part_loss`` class-agnostic
    and, with the box branch and the mean-size coder, per class, and
    ``point_head_box_loss``: each loss and tb term within 1e-6 (float32)
    or 1e-12 (float64) relative, the positive counts equal."""
    cls, part, box, pts, gt, valid = _head_inputs(5, dtype)
    gt_of = np.array([[[2.0, 1.0, 0.0, 4.0, 2.0, 2.0, 0.5, 1]]], dtype)
    face = np.array([[[2.0 * np.cos(0.5) + 2.0, 2.0 * np.sin(0.5) + 1.0, 0.0]]], dtype)
    np.testing.assert_allclose(pih.intra_part_labels(
        torch.from_numpy(face), torch.from_numpy(gt_of), torch.ones(1, 1, dtype=torch.bool)
    ).numpy()[0, 0], [1.0, 0.5, 0.5], atol=1e-5)
    cfg = copy.deepcopy(PARTA2_MODEL_CFG["POINT_HEAD"])
    free_cfg = {**cfg, "CLASS_AGNOSTIC": False, "TARGET_CONFIG": {
        **cfg["TARGET_CONFIG"], "BOX_CODER": "PointResidualCoder",
        "BOX_CODER_CONFIG": {"use_mean_size": True, "mean_size": MEAN_SIZES}},
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {"point_cls_weight": 1.0, "point_box_weight": 2.0,
                                         "point_part_weight": 0.5, "code_weights": [1.0] * 8}}}
    box_cfg = {**free_cfg, "CLS_FC": [], "REG_FC": []}
    jcoder = JPointResidualCoder(use_mean_size=True, mean_size=MEAN_SIZES)
    coder = PointResidualCoder(use_mean_size=True, mean_size=MEAN_SIZES)
    tol = 1e-6 if dtype == "float32" else 1e-12
    with _exact_f64() if dtype == "float64" else contextlib.nullcontext():
        j = [jnp.asarray(a) for a in (cls, part, box, pts, gt, valid)]
        runs = {
            "agnostic": (lambda: j_pih.point_intra_part_loss(
                j[0][..., :1], j[1], j[3], j[5], j[4], JEasyDict(cfg)),
                lambda t: pih.point_intra_part_loss(
                    t[0][..., :1], t[1], t[3], t[5], t[4], EasyDict(cfg))),
            "box branch": (lambda: j_pih.point_intra_part_loss(
                j[0], j[1], j[3], j[5], j[4], JEasyDict(free_cfg), point_box_preds=j[2],
                box_coder=jcoder), lambda t: pih.point_intra_part_loss(
                t[0], t[1], t[3], t[5], t[4], EasyDict(free_cfg), point_box_preds=t[2],
                box_coder=coder)),
            "point_head_box": (lambda: j_phb.point_head_box_loss(
                j[0], j[2], j[3], j[4], jcoder, JEasyDict(box_cfg), 2),
                lambda t: phb.point_head_box_loss(t[0], t[2], t[3], t[4], coder,
                                                  EasyDict(box_cfg), 2)),
        }
        want = {k: jax.device_get(jax.jit(f)()) for k, (f, _) in runs.items()}
    t = [torch.from_numpy(a) for a in (cls, part, box, pts, gt, valid)]
    for name, (_, port) in runs.items():
        loss, tb = port(t)
        w_loss, w_tb = want[name]
        assert abs(loss.item() - float(w_loss)) <= tol * abs(float(w_loss)), name
        assert set(tb) == set(w_tb), name
        for k, v in w_tb.items():
            assert abs(float(tb[k]) - float(v)) <= tol * max(abs(float(v)), 1e-3), (name, k)
        assert float(tb["point_pos_num"]) == float(w_tb["point_pos_num"]) > 0


# ---------------------------------------------------------------- the RoI head

def _roi_head_cfg(**over):
    cfg = copy.deepcopy(PARTA2_MODEL_CFG["ROI_HEAD"])
    cfg["SHARED_FC"], cfg["CLS_FC"], cfg["REG_FC"] = [24, 16, 16], [8, 8], [8]
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("disable_part", [False, True])
def test_parta2_head_equals_jax(disable_part):
    """``PartA2HeadNet`` (a 4^3 pool, three shared layers) in training mode,
    dropout after shared layers 0 and 1 and after the first cls and reg
    layers, JAX's keep masks (read off its Dropout calls) fed: ``rcnn_cls``
    / ``rcnn_reg`` within 1e-5, the statistics within 1e-5 relative; at
    eval within 1e-5; with ``DISABLE_PART`` and ``SEG_MASK_SCORE_THRESH``
    0 (Part-A2-free) the voxel centres pooled instead."""
    cfg = _roi_head_cfg(DISABLE_PART=disable_part,
                        SEG_MASK_SCORE_THRESH=0.0 if disable_part else 0.3)
    rs = np.random.RandomState(6)
    R, Vh, C = 4, 200, 6
    rois = np.concatenate([rs.uniform(0.5, 2.5, (B, R, 3)), rs.uniform(0.8, 2.0, (B, R, 3)),
                           rs.uniform(-1, 1, (B, R, 1))], axis=-1).astype(np.float32)
    coords = (rois[:, rs.randint(0, R, Vh), :3] + rs.uniform(-0.8, 0.8, (B, Vh, 3))).astype(
        np.float32)
    seg = np.maximum(rs.randn(B, Vh, C), 0).astype(np.float32)
    offsets = rs.rand(B, Vh, 3).astype(np.float32)
    scores = rs.rand(B, Vh).astype(np.float32)
    valid = rs.rand(B, Vh) < 0.9
    inputs = (coords, seg, offsets, scores, valid, rois)
    jhead = j_pa2.PartA2HeadNet(model_cfg=JEasyDict(cfg), code_size=7, num_class=1)
    args = [jnp.asarray(a) for a in inputs]
    variables = _perturb(jhead.init(jax.random.PRNGKey(0), *args), 7)
    port = PartA2HeadNet(EasyDict(cfg), C, 7, 1)
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
    keep = {name: torch.from_numpy(np.array(m)).reshape(B, R, -1)
            for name, m in zip(("shared0", "shared1", "cls0", "reg0"), masks)}
    port.train()
    t_in = [torch.from_numpy(a) for a in inputs]
    cls_g, reg_g = port(*t_in, keep)
    np.testing.assert_allclose(cls_g.detach().numpy(), np.asarray(cls_w), atol=1e-5, rtol=0)
    np.testing.assert_allclose(reg_g.detach().numpy(), np.asarray(reg_w), atol=1e-5, rtol=0)
    got = dict(port.named_buffers())
    for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(mut["batch_stats"]))[0]:
        *mods, leaf = [p.key for p in path]
        key = ".".join(mods + [{"mean": "running_mean", "var": "running_var"}[leaf]])
        np.testing.assert_allclose(got[key].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    load_jax_variables(port, variables)
    port.eval()
    with torch.no_grad():
        cls_g, reg_g = port(*t_in)
    cls_w, reg_w = jax.jit(lambda v: jhead.apply(v, *args, train=False))(variables)
    np.testing.assert_allclose(cls_g.numpy(), np.asarray(cls_w), atol=1e-5, rtol=0)
    np.testing.assert_allclose(reg_g.numpy(), np.asarray(reg_w), atol=1e-5, rtol=0)
    part, _ = port.pool(*t_in)
    assert 0.05 < float((part != 0).any(dim=1).float().mean()) < 1.0


# ---------------------------------------------------------------- the detectors

def _gt_near(rois, labels, valid, centres, seed=6):
    """Two gt boxes a frame a little off two valid RoIs (their labels, 5 %
    larger), so that the sampler finds foreground RoIs; a third around the
    frame's first voxel centre, so that the point head has positives; and a
    padded row."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((B, 4, 8), np.float64)
    for b in range(B):
        idx = np.flatnonzero(valid[b])[[0, 3]]
        gt[b, :2, :7] = rois[b, idx] + rs.uniform(-0.02, 0.02, (2, 7))
        gt[b, :2, 3:6] = np.abs(rois[b, idx, 3:6]) * 1.05
        gt[b, :2, 7] = labels[b, idx]
        gt[b, 2] = [*centres[b, 0], 1.6, 1.6, 1.6, 0.3, 1]
    return gt


def gt_near_train_rois(model, batch):
    """``_gt_near`` the proposals of ``model``'s first stage in training mode
    in float64, run on a copy."""
    probe = copy.deepcopy(model).double().train()
    tb = _tb(batch, torch.float64)
    with torch.no_grad():
        first = probe.first_stage(tb["voxels"], tb["voxel_coords"], tb["voxel_num_points"])
        props = RHT.proposal_layer(first["batch_cls_preds"], first["batch_box_preds"],
                                   probe.roi_cfg.NMS_CONFIG.TRAIN)
    return _gt_near(*(props[k].numpy() for k in ("rois", "roi_labels", "roi_valid")),
                    first["point_coords"].numpy())


def random_variables(jmodel, args, seed):
    """A flax variable tree of ``jmodel`` as numpy, its shapes from
    ``jax.eval_shape`` (no compile): kernels normal over sqrt(fan-in), the
    BatchNorms and biases as ``_perturb`` draws them."""
    shapes = jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a), *args)
    rs = np.random.RandomState(seed)

    def one(path, s):
        if path[-1].key.endswith(("kernel", "kernel1", "kernel2")):
            return rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return np.zeros(s.shape)

    return _perturb(jax.tree_util.tree_map_with_path(one, shapes), seed)


def jax_run(jcls, cfg_fn, backbone, batch, classes=CLASSES):
    """The tiny JAX detector ``jcls`` of ``cfg_fn(backbone, dp_ratio,
    score_type)`` on the batch: at eval in float32 (forward and the refined
    post-processing) with random weights (:func:`random_variables`), and in
    training mode in float64 with DP_RATIO 0 and ``CLS_SCORE_TYPE`` cls
    (loss, gradient, statistics and proposals, its sampler drawing from
    ``FEED_KEY``), the gt near the training RoIs.  One compile each."""
    cfg = EasyDict(cfg_fn(backbone))
    build = lambda c: jcls(model_cfg=JEasyDict(c), num_class=len(classes),  # noqa: E731
                           input_channels=4, **{**GEOMETRY, "class_names": classes})
    jmodel = build(cfg_fn(backbone))
    args = _args(batch)
    variables = random_variables(jmodel, args, 3)

    def predict(v, *a):
        out = jmodel.apply(v, *a, train=False)
        out.pop("multi_scale_3d_features", None)
        return out, j_vrcnn.post_processing(out, JEasyDict(cfg))

    out, post = jax.device_get(jax.jit(predict)(variables, *args))
    cfg0 = EasyDict(cfg_fn(backbone, 0.0, "cls"))
    jmodel0 = build(cfg_fn(backbone, 0.0, "cls"))
    probe = build_network(cfg0, len(classes), device="cpu", **{**GEOMETRY,
                                                                "class_names": classes})
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

        def loss_fn(params, gt_, *a):
            o, mut = jmodel0.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                   *a, gt_boxes=gt_, train=True, mutable=["batch_stats"],
                                   rngs={"proposal": jax.random.PRNGKey(0)})
            loss, tb = jmodel0.apply(v64, o, gt_, list(classes), method=jmodel0.loss)
            return loss, (tb, mut["batch_stats"], o["roi_targets"]["_proposals"])

        (loss, (tb, stats, props)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v64["params"], jnp.asarray(gt), *a64)
        f64 = dict(variables=v64, loss=float(loss), tb={k: float(x) for k, x in tb.items()},
                   grads=jax.device_get(grads), stats=jax.device_get(stats),
                   proposals=jax.device_get(props))
    model = build_network(cfg, len(classes), device="cpu",
                          **{**GEOMETRY, "class_names": classes}).eval()
    load_jax_variables(model, variables)
    return dict(backbone=backbone, cfg=cfg, cfg0=cfg0, variables=variables, out=out, post=post,
                gt=gt, f64=f64, model=model, classes=classes)


def check_eval(run, batch):
    """The port at eval in float32 against ``run`` (:func:`jax_run`): the
    voxel centres within 1e-6, the decoder's features within 1e-5 of their
    largest |value|, the first-stage logits within 2e-3, the RoIs, labels
    and validity equal, the part and point scores within 2e-3, ``rcnn_cls``
    within 2e-3, the refined boxes within 1e-3, the detections paired box
    for box."""
    model, want = run["model"], run["out"]
    with torch.no_grad():
        out = model.forward_batch(_tb(batch))
        post = get_post_processor(type(model).__name__)(out, run["cfg"])
    np.testing.assert_allclose(out["point_coords"].numpy(), want["point_coords"], atol=1e-6,
                               rtol=0)
    for key, tol in (("point_cls_preds", 2e-3), ("point_part_preds", 2e-3),
                     ("point_cls_scores", 2e-3)):
        err = np.abs(out[key].numpy() - want[key]).max()
        assert err <= tol, (key, err)
    for key in ("roi_labels", "roi_valid"):
        np.testing.assert_array_equal(out[key].numpy(), want[key], err_msg=key)
    assert want["roi_valid"].sum() > 4
    np.testing.assert_allclose(out["rois"].numpy(), want["rois"], atol=1e-4, rtol=0)
    for key, tol in (("rcnn_cls", 2e-3), ("batch_box_preds", 1e-3)):
        err = np.abs(out[key].numpy() - want[key]).max()
        assert err <= tol, (key, err)
    post = {k: v.numpy() for k, v in post.items()}
    assert post["pred_counts"].min() > 0
    box_err, score_err = _match(post, run["post"])
    assert box_err <= 1e-3 and score_err <= 1e-4
    return out


def check_float64(run, batch):
    """The port's training forward, loss and backward in float64 from the
    JAX weights, the sampler fed JAX's draws (from its proposals), against
    ``run``: the loss and its tb terms within 1e-10 relative, every gradient
    leaf within 1e-10 of its largest |gradient|, the running statistics
    within 1e-9; foreground RoIs sampled, the point loss positive, the
    backbone, point head and RoI head trained."""
    f64, cfg0, gt = run["f64"], run["cfg0"], run["gt"]
    geometry = {**GEOMETRY, "class_names": run["classes"]}
    model = build_network(cfg0, len(run["classes"]), device="cpu", **geometry).double()
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
    assert set(tb) == set(f64["tb"])
    for k, w in f64["tb"].items():
        assert abs(float(tb[k].detach()) - w) <= 1e-10 * max(abs(w), 1e-3), k
    ref = build_network(cfg0, len(run["classes"]), device="cpu", **geometry).double()
    load_jax_variables(ref, {"params": f64["grads"],
                             "batch_stats": f64["variables"]["batch_stats"]})
    want = dict(ref.named_parameters())
    worst = []
    for name, p in model.named_parameters():
        scale = want[name].abs().max().item()
        if scale == 0:
            assert p.grad is None or p.grad.abs().max().item() == 0, name
            continue
        worst.append(((p.grad - want[name]).abs().max().item() / scale, name))
    worst.sort(reverse=True)
    assert worst[0][0] <= 1e-10, f"gradients, worst first: {worst[:4]}"
    _stats_close(model, f64["stats"], atol=1e-9)
    moved = {n.split(".")[0] for n, p in model.named_parameters()
             if p.grad is not None and p.grad.abs().max() > 0}
    assert {"backbone_3d", "point_head", "roi_head"} <= moved




def export_equals_eager(cfg, batch, tmp_path, classes=CLASSES):
    """The tiny program of ``cfg`` over seeded weights, traced by
    ``torch.export`` at the voxel spec, saved and reloaded: the eager
    closure's outputs exactly."""
    geometry = {**GEOMETRY, "class_names": classes}
    model = init_random_weights(build_network(cfg, len(classes), device="cpu", **geometry),
                                4).eval()
    dev_batch = _tb(batch)
    exported = serving.export_serving(model, cfg, dev_batch)
    path = tmp_path / "parta2_b2.pt2"
    full = EasyDict(MODEL=cfg, CLASS_NAMES=list(classes), DATA_CONFIG=EasyDict(
        DATA_PROCESSOR=[EasyDict(NAME="transform_points_to_voxels", VOXEL_SIZE=list(VOXEL_SIZE),
                                 MAX_POINTS_PER_VOXEL=P, MAX_NUMBER_OF_VOXELS=V)],
        POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z", "intensity"]}))
    meta = serving.serving_meta(full, "tiny.yaml", dev_batch, exported)
    assert list(meta["inputs"]) == ["voxels", "voxel_coords", "voxel_num_points"]
    assert serving.serving_input_spec(full, B, model) == {
        k: (tuple(v.shape), v.dtype) for k, v in dev_batch.items()}
    serving.save_serving(exported, path, meta)
    predict, _ = serving.load_serving(path)
    got = predict(dev_batch)
    want = serving.make_predict_fn(model, cfg)(dev_batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(want["pred_counts"].min()) >= 0
