"""The CenterPoint slice of pdanet_tpu_torch against the JAX package, on the
CPU, mirroring ``tests/test_centerpoint.py``: the shipped yaml's
``SparseVoxelResBackBone8x`` at the tiny grid of ``tests/test_torch_second.py``
(0.05 x 0.05 x 0.1 m cells, 144 x 128 x 40, so a 36 x 32 heatmap of 0.2 m
cells at stride 4), ``test_centerpoint.py``'s tiny BEV backbone and head,
two frames of 256 voxels from a numpy seed, weights carried from the flax
variables by the weight bridge.  The JAX side runs jitted on the CPU.

* Targets: the heatmap within 1e-6 of JAX's (its float32 ``exp`` is not
  rounded correctly; the port's is the float64 one rounded, the same bits
  on every device) with the same cells at exactly 1, ``inds`` and
  ``mask`` equal, also for centres on cell borders and an ulp either side
  (XLA's quotients by constants are products with reciprocals), and the
  per-box numpy oracle of ``test_centerpoint.py`` within 1e-5.
* ``topk_heatmap`` on a heatmap with ties: indices equal to ``lax.top_k``'s.
* Both losses in float64 within 1e-12 relative, with the ``num_pos == 0``
  branch and non-finite targets.
* Eval in float32: heatmaps within 1e-5, boxes within 1e-4, top-K indices
  and the NMS keep mask equal on the port's maps, detections paired.
* Training in float64: the loss within 1e-12 relative and every gradient
  leaf within 1e-10 of its scale, the port fed JAX's float32 heatmap (held
  to it above); two Gloo ranks equal to one process.
* The exported program equal to the eager closure; the shipped
  ``centerpoint.yaml`` filled by a JAX tree leaf for leaf.
"""

import copy
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.dense_heads import center_head as j_ch
from pdanet_tpu.models.detectors.centerpoint import post_processing as j_post
from pdanet_tpu.models.model_utils import centernet_utils as j_cu
from pdanet_tpu.utils import loss_utils as j_loss
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.blocks import init_random_weights
from pdanet_tpu_torch.models.dense_heads import center_head as ch
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.models.model_utils import centernet_utils as cu
from pdanet_tpu_torch.train import build_optimizer_and_schedule, make_train_step
from pdanet_tpu_torch.utils import loss_utils
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_centerpoint import CP_MODEL_CFG, _assign_oracle
from test_torch_pointpillar import _match, _stats_close
from test_torch_second import (B, CLASSES, GEOMETRY, GRID, PCR, VOXEL, _exact_f64, _gt, _tb,
                               jax_variables, make_batch)

REPO = Path(__file__).resolve().parent.parent
CP_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "centerpoint.yaml"
MAP_W, MAP_H = GRID[0] // 4, GRID[1] // 4  # the heatmap: 36 x 32 cells of 0.2 m


def cp_cfg():
    """``test_centerpoint.py``'s CenterPoint over the yaml's sparse residual
    backbone at the tiny widths of ``test_torch_second.py``, its score
    threshold at 0.535 (perturbed weights put the heatmap near 0.5: every
    candidate would clear 0.1, and about half of the top 64 clear 0.535)."""
    cfg = copy.deepcopy(dict(CP_MODEL_CFG))
    cfg["DENSE_HEAD"]["POST_PROCESSING"]["SCORE_THRESH"] = 0.535
    cfg["BACKBONE_3D"] = {"NAME": "SparseVoxelResBackBone8x", "NUM_FILTERS": [4, 4, 8, 8, 16],
                          "NUM_OUTPUT_FEATURES": 8}
    cfg["MAP_TO_BEV"] = {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 16}
    return cfg


HEAD = cp_cfg()["DENSE_HEAD"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run (the suite runs in
    several worker processes at once)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# ---------------------------------------------------------------- targets

def random_gt(seed, M=8, extent=(0.2, 7.0, -3.0, 3.0)):
    """(B, M, 8) zero-padded gt over the tiny range: 2-7 boxes a frame of
    both classes, one of them on a row of its own class id 3 (no head)."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((B, M, 8), np.float32)
    for b in range(B):
        n = rs.randint(2, M)
        gt[b, :n, 0] = rs.uniform(extent[0], extent[1], n)
        gt[b, :n, 1] = rs.uniform(extent[2], extent[3], n)
        gt[b, :n, 2] = rs.uniform(-2.5, -1.0, n)
        gt[b, :n, 3:6] = rs.uniform(0.5, 4.0, (n, 3))
        gt[b, :n, 6] = rs.uniform(-np.pi, np.pi, n)
        gt[b, :n, 7] = rs.randint(1, 3, n)
    gt[0, 0, 7] = 3
    return gt


def border_gt(pcr, voxel, stride=4, M=24, seed=1):
    """Centres on cell borders of the heatmap, and an ulp either side, in
    float32: x = x0 + k * voxel * stride, the same for y."""
    rs = np.random.RandomState(seed)
    cell = np.float32(voxel * stride)
    gt = np.zeros((B, M, 8), np.float32)
    for b in range(B):
        kx = rs.randint(1, 30, M).astype(np.float32)
        ky = rs.randint(1, 28, M).astype(np.float32)
        x = np.float32(pcr[0]) + kx * cell
        y = np.float32(pcr[1]) + ky * cell
        shift = rs.randint(-1, 2, (2, M))
        x = np.where(shift[0] < 0, np.nextafter(x, -np.inf), np.where(
            shift[0] > 0, np.nextafter(x, np.inf), x))
        y = np.where(shift[1] < 0, np.nextafter(y, -np.inf), np.where(
            shift[1] > 0, np.nextafter(y, np.inf), y))
        gt[b, :, 0], gt[b, :, 1] = x, y
        gt[b, :, 2] = -1.5
        gt[b, :, 3:6] = rs.uniform(0.4, 4.0, (M, 3))
        gt[b, :, 3] = np.where(rs.rand(M) < 0.3, (kx % 7 + 1) * cell, gt[b, :, 3])
        gt[b, :, 6] = rs.uniform(-np.pi, np.pi, M)
        gt[b, :, 7] = rs.randint(1, 3, M)
    return gt


def _assign_both(gt, pcr, voxel, size_xy, dtype=np.float32):
    args = dict(head_class_ids=(1, 2), feature_map_size=size_xy, feature_map_stride=4,
                gaussian_overlap=0.1, min_radius=2)
    want = _to_np(jax.jit(lambda g: j_ch.assign_targets_single_head(
        g, point_cloud_range=np.asarray(pcr), voxel_size=np.asarray(voxel), **args))(
        jnp.asarray(gt)))
    got = ch.assign_targets_single_head(torch.from_numpy(gt.astype(dtype)),
                                        point_cloud_range=pcr, voxel_size=voxel, **args)
    return want, {k: v.numpy() for k, v in got.items()}


FULL_PCR = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)  # centerpoint.yaml
FULL_VOXEL = (0.05, 0.05, 0.1)


@pytest.mark.parametrize("case", ["random", "borders", "borders_full_width"])
def test_heatmap_targets_match_jax(case):
    """``inds`` and ``mask`` equal to JAX's, the heatmap within 1e-6 with the
    same cells at exactly 1 (the positives of the focal loss), the
    regression targets within 1e-6; on random boxes also the per-box numpy
    oracle of ``test_centerpoint.py`` within 1e-5.  The border cases put
    centres on cell borders of the tiny map and of the yaml's 352 x 400
    map, and an ulp either side."""
    if case == "borders_full_width":
        pcr, voxel, size = FULL_PCR, FULL_VOXEL, (352, 400)
        gt = border_gt(pcr, voxel[0])
    else:
        pcr, voxel, size = PCR, VOXEL, (MAP_W, MAP_H)
        gt = random_gt(3) if case == "random" else border_gt(pcr, voxel[0])
    want, got = _assign_both(gt, pcr, voxel, size)
    np.testing.assert_array_equal(got["inds"], want["inds"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert want["mask"].sum() >= 4
    assert got["heatmap"].dtype == np.float32
    np.testing.assert_allclose(got["heatmap"], want["heatmap"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["heatmap"] == 1.0, want["heatmap"] == 1.0)
    np.testing.assert_allclose(got["target_boxes"], want["target_boxes"], atol=1e-6, rtol=0)
    if case == "random":
        for b in range(B):
            hm, ret, inds, mask = _assign_oracle(gt[b], [1, 2], size, 4, pcr, voxel)
            np.testing.assert_allclose(got["heatmap"][b].transpose(2, 0, 1), hm, atol=1e-5,
                                       rtol=0)
            np.testing.assert_array_equal(got["inds"][b], inds)
            np.testing.assert_array_equal(got["mask"][b].astype(np.int64), mask)
            np.testing.assert_allclose(got["target_boxes"][b] * mask[:, None],
                                       ret * mask[:, None], atol=1e-5, rtol=0)


@pytest.mark.parametrize("overlap", [0.1, 0.5])
def test_gaussian_radius_matches_jax(overlap):
    """The radius in cells, float32: within 1e-5 relative of JAX's and its
    integer part equal, on extents drawn around integer radii."""
    rs = np.random.RandomState(4)
    h = rs.uniform(0.1, 60.0, 200000).astype(np.float32)
    w = rs.uniform(0.1, 60.0, 200000).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: j_cu.gaussian_radius(a, b, overlap))(h, w))
    got = cu.gaussian_radius(torch.from_numpy(h), torch.from_numpy(w), overlap).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got.astype(np.int32), want.astype(np.int32))


def test_topk_heatmap_ties_match_lax_top_k():
    """Scores quantized to 16 levels (many ties within a class and across
    classes): scores, flat indices, classes, ys and xs equal to JAX's two
    ``lax.top_k`` stages (the lower index first among equals)."""
    rs = np.random.RandomState(5)
    hm = (rs.randint(0, 16, (B, 9, 11, 3)) / 16.0).astype(np.float32)
    hm[1, :, :, 1] = 0.5  # a class of one value
    for K in (5, 40, 99):
        want = _to_np(jax.jit(lambda s: j_cu.topk_heatmap(s, K))(hm))
        got = cu.topk_heatmap(torch.from_numpy(hm), K)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w)


def test_decode_matches_jax():
    """The fixed-shape decode on random maps: boxes within 1e-5, scores,
    labels and the validity mask (range limits and the strict score
    threshold, a score exactly at it included) equal."""
    rs = np.random.RandomState(6)
    shp = (B, MAP_H, MAP_W)
    maps = dict(heatmap=rs.rand(*shp, 2).astype(np.float32),
                rot_cos=rs.randn(*shp, 1).astype(np.float32),
                rot_sin=rs.randn(*shp, 1).astype(np.float32),
                center=rs.rand(*shp, 2).astype(np.float32),
                center_z=rs.randn(*shp, 1).astype(np.float32),
                dim=np.exp(rs.randn(*shp, 3)).astype(np.float32))
    maps["heatmap"][0, 3, 4, 1] = 0.995  # over the limit range after the decode
    maps["center"][0, 3, 4] = 200.0
    maps["heatmap"][1, 5, 5, 0] = 0.999
    maps["heatmap"][1, 6, 5, 0] = 0.9  # exactly at the threshold: invalid
    kw = dict(point_cloud_range=np.asarray(PCR, np.float32),
              voxel_size=np.asarray(VOXEL, np.float32), feature_map_stride=4, K=50,
              score_thresh=0.9, post_center_limit_range=[0, -3.2, -4, 7.0, 3.2, 0])
    want = _to_np(jax.jit(lambda m: j_cu.decode_bbox_from_heatmap(**m, **kw))(maps))
    got = cu.decode_bbox_from_heatmap(**{k: torch.from_numpy(v) for k, v in maps.items()},
                                      **kw)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert 0 < want[3].sum() < want[3].size


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("positives", [True, False])
def test_focal_loss_centernet_matches_jax_float64(positives):
    """The heatmap focal loss in float64 within 1e-12 relative, with
    positives (normalized by their count) and without (the negatives
    alone, not normalized)."""
    rs = np.random.RandomState(7)
    gt = (rs.rand(B, 12, 10, 3) ** 4).astype(np.float32)
    if positives:
        gt[0, 3, 4, 1] = gt[1, 0, 0, 0] = gt[1, 7, 2, 2] = 1.0
    pred = np.clip(rs.rand(B, 12, 10, 3), 1e-4, 1 - 1e-4)
    with _exact_f64():
        want = float(jax.jit(j_loss.focal_loss_centernet)(pred, jnp.asarray(gt)))
    got = loss_utils.focal_loss_centernet(torch.from_numpy(pred), torch.from_numpy(gt)).item()
    assert abs(got - want) <= 1e-12 * abs(want)


def test_reg_loss_centernet_masks_and_nonfinite_targets_float64():
    """The gathered L1 in float64 within 1e-12: masked slots and a
    non-finite target (inf and NaN) count nothing, the count the valid
    slots'."""
    rs = np.random.RandomState(8)
    pred = rs.randn(B, 6, 8)
    target = rs.randn(B, 6, 8)
    mask = rs.rand(B, 6) < 0.6
    mask[0, 0] = True
    target[0, 0, 3] = np.inf
    target[0, 0, 5] = np.nan
    target[1, 5, 0] = np.nan
    with _exact_f64():
        want = np.asarray(jax.jit(j_loss.reg_loss_centernet)(pred, mask, target))
    got = loss_utils.reg_loss_centernet(torch.from_numpy(pred), torch.from_numpy(mask),
                                        torch.from_numpy(target)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------- the detector

@pytest.fixture(scope="module")
def batch():
    return make_batch()


def jax_cp():
    return j_build(JEasyDict(cp_cfg()), num_class=len(CLASSES), input_channels=4, **GEOMETRY)


@pytest.fixture(scope="module")
def cp_run(batch):
    """The tiny JAX CenterPoint on the batch: at eval in float32 with
    perturbed weights (forward and post-processing), and in training mode
    in float64 (loss, gradient, statistics and each head's targets); one
    compile each."""
    cfg = EasyDict(cp_cfg())
    jmodel = jax_cp()
    variables = jax_variables(jmodel, batch)
    args = [jnp.asarray(batch[k]) for k in ("voxels", "voxel_coords", "voxel_num_points")]

    def predict(v, *a):
        out = jmodel.apply(v, *a, train=False)
        return out, j_post(out, HEAD["POST_PROCESSING"])

    out, post = jax.device_get(jax.jit(predict)(variables, *args))
    out.pop("feature_map_size")
    gt = _gt()
    with _exact_f64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        a64 = [jnp.asarray(batch["voxels"], jnp.float64), *args[1:]]

        def loss_fn(params, gt_):
            o, mut = jmodel.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                  *a64, train=True, mutable=["batch_stats"])
            loss, tb = jmodel.apply(v64, o, gt_, method=jmodel.loss)
            return loss, (tb, mut["batch_stats"])

        (loss, (tb, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], jnp.asarray(gt))
        heatmap = _to_np(jax.jit(lambda g: j_ch.assign_targets_single_head(
            g, (1, 2), (MAP_W, MAP_H), 4, np.asarray(PCR), np.asarray(VOXEL)))(
            jnp.asarray(gt)))["heatmap"]
    f64 = dict(variables=v64, loss=float(loss), tb={k: float(x) for k, x in tb.items()},
               grads=jax.device_get(grads), stats=jax.device_get(stats), heatmap=heatmap)
    model = build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY).eval()
    load_jax_variables(model, variables)
    return dict(cfg=cfg, variables=variables, out=out, post=post, f64=f64, model=model)


def test_centerpoint_eval_matches_jax(batch, cp_run):
    """Eval in float32 through the weight bridge: each head map within 1e-5
    (the heatmap after the sigmoid), the decoded scores within 1e-5 and
    boxes within 1e-4 in JAX's order; the top-K indices and the NMS keep
    mask equal to JAX's on the port's maps; the detections paired box for
    box."""
    model, want = cp_run["model"], cp_run["out"]
    with torch.no_grad():
        out = model.forward_batch(_tb(batch))
        post = get_post_processor("CenterPoint")(out, cp_run["cfg"])
    K = HEAD["POST_PROCESSING"]["MAX_OBJ_PER_SAMPLE"]
    assert out["batch_box_preds"].shape == (B, K, 7)
    hm = torch.sigmoid(out["pred_dicts"][0]["hm"]).numpy()
    np.testing.assert_allclose(hm, jax.nn.sigmoid(want["pred_dicts"][0]["hm"]), atol=1e-5,
                               rtol=0)
    for key, val in out["pred_dicts"][0].items():
        scale = max(np.abs(want["pred_dicts"][0][key]).max(), 1.0)
        np.testing.assert_allclose(val.numpy(), want["pred_dicts"][0][key],
                                   atol=1e-5 * scale, rtol=0, err_msg=key)
    np.testing.assert_allclose(out["batch_score_preds"].numpy(), want["batch_score_preds"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["batch_box_preds"].numpy(), want["batch_box_preds"],
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(out["batch_label_preds"].numpy(), want["batch_label_preds"])
    np.testing.assert_array_equal(out["batch_valid_preds"].numpy(), want["batch_valid_preds"])
    assert 0 < want["batch_valid_preds"].sum() < want["batch_valid_preds"].size

    # the top-K and the post-processing on the port's own maps, both sides
    ours = cu.topk_heatmap(torch.from_numpy(hm), K)
    theirs = _to_np(jax.jit(lambda s: j_cu.topk_heatmap(s, K))(hm))
    for g, w in zip(ours, theirs):
        np.testing.assert_array_equal(g.numpy(), w)
    np_out = {k: out[k].numpy() for k in ("batch_box_preds", "batch_score_preds",
                                          "batch_label_preds", "batch_valid_preds")}
    on_ours = _to_np(jax.jit(lambda o: j_post(o, HEAD["POST_PROCESSING"]))(np_out))
    post = {k: v.numpy() for k, v in post.items()}
    for key in post:
        np.testing.assert_array_equal(post[key], on_ours[key], err_msg=key)
    assert post["pred_counts"].min() > 0
    assert (post["pred_counts"] < out["batch_valid_preds"].sum(dim=1).numpy()).any()
    box_err, score_err = _match(post, cp_run["post"])
    assert box_err <= 1e-4 and score_err <= 1e-5


def test_centerpoint_loss_and_gradients_match_jax_float64(batch, cp_run, monkeypatch):
    """Training mode in float64: the loss and its tb terms within 1e-12
    relative, every gradient leaf within 1e-10 of its largest |gradient|
    (floored at 1e-4 of the model's largest, for the biases before a
    BatchNorm, whose gradient is zero but for rounding), the running statistics within 1e-9 (JAX's masked BatchNorm counts in
    float32).  The port's float32 heatmap target (within 1e-6 of JAX's,
    the same positives) is replaced by JAX's for the comparison: XLA's
    float32 ``exp`` is not rounded correctly, and its last place would move
    the loss by ~1e-8."""
    f64, cfg = cp_run["f64"], cp_run["cfg"]
    real = ch.assign_targets_single_head

    def fed(*args, **kwargs):
        tgt = real(*args, **kwargs)
        hm = tgt["heatmap"].numpy()
        np.testing.assert_allclose(hm, f64["heatmap"], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(hm == 1.0, f64["heatmap"] == 1.0)
        return {**tgt, "heatmap": torch.from_numpy(f64["heatmap"].copy())}

    monkeypatch.setattr(ch, "assign_targets_single_head", fed)
    model = build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY).double()
    load_jax_variables(model, f64["variables"])
    model.train()
    tb_batch = _tb(batch, torch.float64)
    tb_batch["gt_boxes"] = torch.from_numpy(_gt())
    loss, tb = model.loss_batch(model.forward_batch(tb_batch), tb_batch)
    loss.backward()
    assert abs(loss.item() - f64["loss"]) <= 1e-12 * abs(f64["loss"])
    assert tb["loc_loss_head_0"] > 0
    for k, w in f64["tb"].items():
        assert abs(float(tb[k].detach()) - w) <= 1e-12 * abs(w), k
    ref = build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY).double()
    load_jax_variables(ref, {"params": f64["grads"],
                             "batch_stats": f64["variables"]["batch_stats"]})
    want = dict(ref.named_parameters())
    # a conv bias before a BatchNorm has a zero gradient but for rounding:
    # its scale is floored at 1e-4 of the largest gradient (the rounding of
    # the BatchNorm's cancellation is ~1e-16 of that)
    floor = 1e-4 * max(g.abs().max().item() for g in want.values())
    worst = []
    for name, p in model.named_parameters():
        scale = max(want[name].abs().max().item(), floor)
        worst.append(((p.grad - want[name]).abs().max().item() / scale, name))
    worst.sort(reverse=True)
    assert worst[0][0] <= 1e-10, f"gradients, worst first: {worst[:4]}"
    assert sum(want[n].abs().max().item() > floor for _, n in worst) > len(worst) // 2
    _stats_close(model, f64["stats"], atol=1e-9)


def test_centerpoint_two_ranks_step_like_one_process_float64(batch, tmp_path):
    """Two Gloo processes take one frame each of the two-frame batch (two
    gt boxes on frame 0, one on frame 1: the focal loss's positive count
    and the L1's slot count are the global batch's) from the same seeded
    weights, against one process on both frames, in float64: the loss and
    tb scalars within 1e-9 relative, every gradient leaf (summed over the
    ranks) within 1e-9 of its largest |gradient| (floored at 1e-4 of the
    model's largest, as above), the running statistics within 1e-12, the
    two ranks' state bit-equal."""
    cfg = EasyDict(cp_cfg())
    optim_cfg = EasyDict(dict(OPTIMIZER="adam_onecycle", LR=0.01, WEIGHT_DECAY=0.01,
                              MOMS=[0.95, 0.85], PCT_START=0.4, DIV_FACTOR=10,
                              GRAD_NORM_CLIP=10))
    model = init_random_weights(build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY),
                                seed=5).double()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    frames = {**batch, "gt_boxes": _gt().astype(np.float32)}
    spec = tmp_path / "spec.pkl"
    with open(spec, "wb") as f:
        pickle.dump(dict(cfg=cfg, num_class=len(CLASSES), build=dict(GEOMETRY), state=state,
                         optim_cfg=optim_cfg, schedule=(4, 2), dtype=torch.float64,
                         ranks=[dict(batch={k: v[r:r + 1] for k, v in frames.items()})
                                for r in range(2)]), f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dist_step.py"),
                               str(spec), str(r), "2", str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    optimizer, schedule = build_optimizer_and_schedule(model, optim_cfg, 4, 2)
    loss, tb = make_train_step(model, optimizer, schedule)(
        {k: torch.from_numpy(v).double() if v.dtype.kind == "f" else torch.from_numpy(v)
         for k, v in frames.items()})
    assert tb["loc_loss_head_0"] > 0
    want_grads = {n: p.grad for n, p in model.named_parameters()}
    for r, proc in enumerate(procs):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"rank {r}:\n{out[-2000:]}\n{err[-4000:]}"
    got = [torch.load(f"{spec}.rank{r}.pt", weights_only=False) for r in range(2)]
    for key, val in got[0]["state"].items():
        assert torch.equal(got[1]["state"][key], val), key
    res = got[0]
    assert abs(res["loss"].item() - loss.item()) <= 1e-9 * abs(loss.item())
    for k, w in tb.items():
        assert abs(float(res["tb"][k]) - float(w)) <= 1e-9 * max(abs(float(w)), 1e-6), k
    floor = 1e-4 * max(g.abs().max().item() for g in want_grads.values())
    worst = max(((res["grads"][n] - g).abs().max().item() / max(g.abs().max().item(), floor),
                 n) for n, g in want_grads.items())
    assert worst[0] <= 1e-9, worst
    for name, buf in model.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(res["state"][name], buf, rtol=0, atol=1e-12)


def test_centerpoint_exported_program_equals_eager(batch, cp_run, tmp_path):
    """The tiny CenterPoint program traced by ``torch.export``, saved and
    reloaded, gives the eager closure's outputs exactly."""
    model, cfg = cp_run["model"], cp_run["cfg"]
    dev_batch = _tb(batch)
    exported = serving.export_serving(model, cfg, dev_batch)
    path = tmp_path / "centerpoint_b2.pt2"
    full = EasyDict(MODEL=cfg, CLASS_NAMES=list(CLASSES), DATA_CONFIG=EasyDict(
        DATA_PROCESSOR=[EasyDict(NAME="transform_points_to_voxels", VOXEL_SIZE=list(VOXEL),
                                 MAX_POINTS_PER_VOXEL=5, MAX_NUMBER_OF_VOXELS=256)],
        POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z", "intensity"]}))
    serving.save_serving(exported, path, serving.serving_meta(full, "tiny.yaml", dev_batch,
                                                              exported))
    predict, _ = serving.load_serving(path)
    got = predict(dev_batch)
    want = serving.make_predict_fn(model, cfg)(dev_batch)
    assert set(got) == {"pred_boxes", "pred_scores", "pred_labels", "pred_counts"}
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(want["pred_counts"].min()) > 0


def test_build_network_centerpoint_yaml():
    """The shipped yaml at full width, its grid from the dataset (1408 x
    1600 x 40 cells, a 256-channel BEV map, one head of three classes),
    every leaf of a JAX tree of the same config consumed; seeded weights
    put the heatmap's output bias at -2.19, as flax's ``bias_init``; the
    post-processing's K is min(NMS_PRE_MAXSIZE 4096, 1 head x 500)."""
    cfg = cfg_from_yaml_file(str(CP_YAML))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert model.grid_size == (1408, 1600, 40)
    assert model.backbone_3d.num_bev_features == 256
    assert model.dense_head.head_0.hm_out.weight.shape == (3, 64, 3, 3)
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
    torch.testing.assert_close(model.dense_head.head_0.hm_out.bias, torch.from_numpy(
        np.asarray(variables["params"]["dense_head"]["head_0"]["hm_out"]["bias"])), rtol=0,
        atol=0)
    init_random_weights(model, 0)
    assert (model.dense_head.head_0.hm_out.bias == torch.tensor(-2.19)).all()
    assert (model.dense_head.head_0.center_out.bias == 0).all()
    post = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    assert min(post.NMS_CONFIG.NMS_PRE_MAXSIZE, post.MAX_OBJ_PER_SAMPLE) == 500
    assert post.NMS_CONFIG.NMS_THRESH == 0.7


# ---------------------------------------------------------------- non-finite boxes

def nonfinite_boxes(seed=0, K=48):
    """(1, K, 7) float32 boxes of a frame: finite ones in a 10 x 10 m patch
    (so that many pairs overlap), then boxes with inf, -inf or NaN in x, y,
    dx, dy or the heading, boxes of zero length or width, and a copy of a
    finite box with an infinite length."""
    rs = np.random.RandomState(seed)
    b = np.zeros((1, K, 7), np.float32)
    b[0, :, 0] = rs.uniform(0, 10, K)
    b[0, :, 1] = rs.uniform(-5, 5, K)
    b[0, :, 3:6] = rs.uniform(1, 4, (K, 3))
    b[0, :, 6] = rs.uniform(-3, 3, K)
    bad = [(0, np.inf), (1, -np.inf), (3, np.inf), (4, np.nan), (6, np.nan), (0, np.nan),
           (6, np.inf), (3, 0.0), (4, 0.0), (1, np.nan), (4, np.inf), (3, np.nan)]
    for i, (col, val) in enumerate(bad, start=1):
        b[0, 2 * i, col] = val
    b[0, 30, 3:5] = 0.0
    b[0, 32] = b[0, 33]
    b[0, 32, 3] = np.inf
    return b


def _same_nan(a, b):
    return np.array_equal(np.isnan(a), np.isnan(b))


def test_nonfinite_boxes_self_iou_matches_jax():
    """The plain self-IoU on inf / NaN / zero-size boxes: NaN at the same
    pairs as the JAX package's XLA self-IoU (a NaN extent or heading makes
    its row and column NaN, an infinite centre or extent gives 0), the
    finite values within the IoU tests' rtol 2e-4 / atol 2e-5."""
    from pdanet_tpu.ops.rotated_iou import boxes_iou_bev_batched_self as j_iou
    from pdanet_tpu_torch.ops.rotated_iou import boxes_iou_bev_batched_self_plain

    b = nonfinite_boxes()
    want = np.asarray(jax.jit(j_iou)(jnp.asarray(b)))
    got = boxes_iou_bev_batched_self_plain(torch.from_numpy(b)).numpy()
    assert _same_nan(got, want) and np.isnan(want).any()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-4, atol=2e-5)
    assert (want[fin] > 0.05).sum() > 2 * b.shape[1]  # overlapping pairs besides the diagonal


@pytest.mark.parametrize("thresh", [0.01, 0.1, 0.3])
def test_nonfinite_boxes_nms_keep_matches_jax(thresh):
    """The greedy walk fed JAX's IoU of those boxes (NaN entries suppress
    nothing: ``NaN > thresh`` is false on both sides), with some candidates
    invalid: the keep mask equal to JAX's."""
    from pdanet_tpu.ops.nms import greedy_nms_mask_batched as j_nms
    from pdanet_tpu.ops.rotated_iou import boxes_iou_bev_batched_self as j_iou
    from pdanet_tpu_torch.ops.nms import greedy_nms_mask_batched

    b = nonfinite_boxes()
    iou = np.asarray(jax.jit(j_iou)(jnp.asarray(b)))
    valid = np.ones(b.shape[:2], bool)
    valid[0, [5, 17, 40]] = False
    want = np.asarray(j_nms(jnp.asarray(iou), jnp.asarray(valid), thresh))
    got = greedy_nms_mask_batched(torch.from_numpy(iou.copy()), torch.from_numpy(valid),
                                  thresh).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < valid.sum()


def test_nonfinite_boxes_batched_nms_candidates_matches_jax():
    """``batched_nms_candidates`` on two frames of those boxes with a NaN
    and an infinite score among them and a score threshold: the detections
    (boxes with their inf / NaN, scores, labels, counts) equal to JAX's."""
    from pdanet_tpu.models.model_utils.model_nms_utils import batched_nms_candidates as j_nms
    from pdanet_tpu_torch.models.model_utils.model_nms_utils import batched_nms_candidates

    rs = np.random.RandomState(9)
    boxes = np.concatenate([nonfinite_boxes(0), nonfinite_boxes(1)])
    scores = rs.rand(2, boxes.shape[1]).astype(np.float32)
    scores[0, 3], scores[1, 8] = np.nan, np.inf
    labels = rs.randint(1, 4, scores.shape).astype(np.int32)
    valid = rs.rand(*scores.shape) < 0.9
    cfg = EasyDict(NMS_THRESH=0.1, NMS_PRE_MAXSIZE=40, NMS_POST_MAXSIZE=24)
    want = _to_np(jax.jit(lambda *a: j_nms(*a, JEasyDict(cfg), score_thresh=0.05))(
        boxes, scores, labels, valid))
    got = batched_nms_candidates(*(torch.from_numpy(a) for a in (boxes, scores, labels, valid)),
                                 cfg, score_thresh=0.05)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    kept = want["pred_boxes"][0, :want["pred_counts"][0]]
    assert not np.isfinite(kept).all()  # non-finite boxes reach the output
