"""The multi-head anchor head and multi-class NMS of pdanet_tpu_torch
against the JAX package, on the CPU, at ``tests/test_multihead.py``'s
tiny configs (a 4 x 4 BEV map of ``tests/test_second.py``'s 32 x 32 x 8
grid, three classes), inputs from a numpy seed, weights carried from the
flax variables by the weight bridge.  The JAX side runs jitted on the
CPU; its NMS takes the XLA walk there.

* ``AnchorHeadMultiNet`` with the shared conv, shared and separate heads
  (``test_multihead.py:51``) in training mode: every head's maps and the
  flattened (B, A, ...) predictions within 1e-5, the targets equal, the
  loss terms within 1e-6 relative (JAX's loss fed the port's anchors:
  for a group of several classes the JAX package's flat anchors are in x
  order, not the predictions' order, ROADMAP queue 3); separate 3x3
  regression branches (``:116``).
* ``batched_multi_classes_nms`` equal to JAX's: independent classes
  (``:146``), and on random candidates with a per-class ``NMS_THRESH``;
  ``iassd.post_processing`` with ``MULTI_CLASSES_NMS`` equal to JAX's,
  every class's keep mask equal.
* SECOND over the dense backbone and ``AnchorHeadMulti`` (``:178``): at
  eval in float32 the logits within 2e-3 and the per-class detections
  paired box for box; in training mode in float64 the loss and its tb
  terms within 1e-10 relative, every gradient leaf within 1e-10 of its
  largest, the running statistics within 1e-9; the tiny exported program
  equal to the eager closure; the shipped ``second_multihead.yaml`` built
  through the dataset's geometry and filled by a JAX tree.
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
from pdanet_tpu.models.dense_heads import anchor_head_multi as JAHM
from pdanet_tpu.models.detectors.iassd import post_processing as j_post
from pdanet_tpu.models.model_utils import model_nms_utils as j_nms_utils
from pdanet_tpu.utils.box_coder_utils import build_box_coder as j_coder
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.dense_heads import anchor_head as AH
from pdanet_tpu_torch.models.dense_heads import anchor_head_multi as AHM
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.models.detectors.iassd import post_processing
from pdanet_tpu_torch.models.model_utils import model_nms_utils as nms_utils
from pdanet_tpu_torch.utils.box_coder_utils import build_box_coder
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_multihead import ANCHOR_CFG, CLASS_NAMES, GRID, PC_RANGE, RPN_HEAD_CFGS
from test_second import SECOND_MODEL_CFG
from test_torch_pointpillar import _match, _perturb, _stats_close
from test_torch_second import _exact_f64
from test_torch_second_iou import B, P, V, _args, _tb, make_batch
from test_two_stage import _boxes

REPO = Path(__file__).resolve().parent.parent
YAML = REPO / "tools" / "cfgs" / "kitti_models" / "second_multihead.yaml"
VOXEL = (0.2, 0.2, 0.5)
CLASSES = ("Car", "Pedestrian")
GEOMETRY = dict(grid_size=GRID, voxel_size=VOXEL, point_cloud_range=PC_RANGE,
                class_names=CLASSES)
LOSS_WEIGHTS = {"cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
                "code_weights": [1.0] * 7, "pos_cls_weight": 1.0, "neg_cls_weight": 2.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _anchors():
    anchors, num_per_loc = AH.generate_anchors(ANCHOR_CFG, GRID, PC_RANGE)
    _, per_class = AH.flat_anchors_per_class(anchors)
    return per_class, num_per_loc


def _gt(M=2):
    gt = np.zeros((2, M, 8), np.float32)
    gt[:, 0] = [3.0, 0.5, -0.8, 3.9, 1.6, 1.56, 0.3, 1]
    gt[:, 1] = [1.5, -1.0, -0.2, 0.8, 0.6, 1.73, -0.5, 2]
    return gt


@pytest.mark.parametrize("separate", [False, True])
def test_multihead_layout_and_loss_equal_jax(separate):
    """Groups [Car], [Pedestrian, Cyclist] on an (2, 4, 4, 8) map in
    training mode (the shared BatchNorm on batch statistics): each head's
    maps and the flattened predictions within 1e-5 (a separate head's
    other classes at -1e9), the targets equal, the cls / loc / dir loss
    terms within 1e-6 relative.  The flat anchors equal JAX's where a
    group holds one class; for the two-class group they are in the
    predictions' order, which JAX's are not."""
    per_class, num_per_loc = _anchors()
    groups = AHM.build_head_groups(RPN_HEAD_CFGS, CLASS_NAMES)
    flat, counts = AHM.multihead_flat_anchors(per_class, groups)
    j_flat, j_counts = JAHM.multihead_flat_anchors(per_class, groups)
    assert counts == j_counts and flat.shape == (sum(counts), 7)
    np.testing.assert_array_equal(flat[:counts[0]], np.asarray(j_flat)[:counts[0]])
    assert not np.array_equal(flat[counts[0]:], np.asarray(j_flat)[counts[0]:])
    # the predictions' order: location-major, the group's classes at a location
    loc = np.concatenate([per_class[1], per_class[2]], axis=-2)
    np.testing.assert_array_equal(flat[counts[0]:], loc.reshape(-1, 7))

    mcfg = {"SHARED_CONV_NUM_FILTER": 16, "SEPARATE_MULTIHEAD": separate,
            "USE_DIRECTION_CLASSIFIER": True, "NUM_DIR_BINS": 2,
            "RPN_HEAD_CFGS": RPN_HEAD_CFGS}
    code = 7
    jnet = JAHM.AnchorHeadMultiNet(model_cfg=mcfg, head_groups=tuple(tuple(g) for g in groups),
                                   num_anchors_per_loc_per_class=tuple(num_per_loc),
                                   code_size=code, num_class=3)
    x = np.random.RandomState(0).rand(2, 4, 4, 8).astype(np.float32)
    variables = _perturb(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    j_outs, _ = jax.jit(lambda v, a: jnet.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    net = AHM.AnchorHeadMultiNet(mcfg, 8, groups, num_per_loc, code, 3)
    load_jax_variables(net, variables)
    outs = net.train()(torch.from_numpy(x))
    for h, (got, want) in enumerate(zip(outs, j_outs)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=0,
                                       err_msg=f"head {h}")
    j_preds = JAHM.concat_head_preds(j_outs, groups, 3, code, 2, separate)
    preds = AHM.concat_head_preds(outs, groups, 3, code, 2, separate)
    for g, w in zip(preds, j_preds):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=0)
    if separate:
        assert preds[0][0, 0, 1].item() <= -1e8 and np.isfinite(preds[0][0, 0, 0].item())

    coder, j_box_coder = build_box_coder("ResidualCoder", {}), j_coder("ResidualCoder", {})
    thresholds = [(c["matched_threshold"], c["unmatched_threshold"]) for c in ANCHOR_CFG]
    targets = AHM.assign_targets_multi([torch.from_numpy(a) for a in per_class], groups,
                                       torch.from_numpy(_gt()), [1, 2, 3], thresholds, coder)
    j_targets = jax.jit(lambda g: JAHM.assign_targets_multi(
        [jnp.asarray(a) for a in per_class], groups, g, [1, 2, 3], thresholds, j_box_coder))(
        jnp.asarray(_gt()))
    for k in j_targets:
        np.testing.assert_allclose(targets[k].numpy(), np.asarray(j_targets[k]), atol=1e-6,
                                   rtol=0, err_msg=k)
    labels = targets["box_cls_labels"].numpy()
    assert set(np.unique(labels[:, :counts[0]])) <= {-1, 0, 1}
    assert (labels > 0).sum() > 0
    loss, tb = AHM.anchor_head_multi_loss(outs, groups, counts, targets, torch.from_numpy(flat),
                                          3, LOSS_WEIGHTS, code, separate=separate)
    _, j_tb = jax.jit(lambda o, t: JAHM.anchor_head_multi_loss(
        o, groups, counts, t, jnp.asarray(flat), 3, LOSS_WEIGHTS, code, separate=separate))(
        j_outs, j_targets)
    assert set(tb) == set(j_tb) and float(j_tb["rpn_loss_dir"]) > 0
    for k in j_tb:
        w = float(j_tb[k])
        assert abs(float(tb[k].detach()) - w) <= 1e-6 * abs(w), k


def test_separate_reg_branches_equal_jax():
    """``SEPARATE_REG_CONFIG``'s 3x3 branches (one middle conv of 8, the
    REG_LIST reg:2, height:1, size:3, angle:1) at eval: the box maps
    regrouped to the single conv's order within 1e-5 of JAX's."""
    per_class, num_per_loc = _anchors()
    groups = AHM.build_head_groups(RPN_HEAD_CFGS, CLASS_NAMES)
    mcfg = {"SHARED_CONV_NUM_FILTER": 16, "SEPARATE_MULTIHEAD": True,
            "USE_DIRECTION_CLASSIFIER": False, "RPN_HEAD_CFGS": RPN_HEAD_CFGS,
            "SEPARATE_REG_CONFIG": {"NUM_MIDDLE_CONV": 1, "NUM_MIDDLE_FILTER": 8,
                                    "REG_LIST": ["reg:2", "height:1", "size:3", "angle:1"]}}
    jnet = JAHM.AnchorHeadMultiNet(model_cfg=mcfg, head_groups=tuple(tuple(g) for g in groups),
                                   num_anchors_per_loc_per_class=tuple(num_per_loc),
                                   code_size=7, num_class=3)
    x = np.random.RandomState(1).rand(1, 4, 4, 8).astype(np.float32)
    variables = _perturb(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    want = jax.jit(lambda v, a: JAHM.concat_head_preds(jnet.apply(v, a), groups, 3, 7, 2,
                                                       True))(variables, jnp.asarray(x))
    net = AHM.AnchorHeadMultiNet(mcfg, 8, groups, num_per_loc, 7, 3)
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = AHM.concat_head_preds(net.eval()(torch.from_numpy(x)), groups, 3, 7, 2, True)
    flat, _ = AHM.multihead_flat_anchors(per_class, groups)
    assert got[1].shape == (1, flat.shape[0], 7) and got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_multi_classes_nms_independent_per_class():
    """Two overlapping boxes, each the winner of another class: both kept
    (class-agnostic NMS would keep one), with two far boxes; the four
    detections compacted into the leading slots in class order, as JAX's."""
    boxes = np.zeros((1, 4, 7), np.float32)
    boxes[0, 0] = [0, 0, 0, 4, 2, 2, 0]
    boxes[0, 1] = [0.1, 0, 0, 4, 2, 2, 0]
    boxes[0, 2] = [20, 20, 0, 4, 2, 2, 0]
    boxes[0, 3] = [40, 40, 0, 4, 2, 2, 0.5]
    scores = np.zeros((1, 4, 2), np.float32)
    scores[0, 0, 0], scores[0, 1, 1], scores[0, 2, 0], scores[0, 3, 1] = 0.9, 0.8, 0.7, 0.6
    cfg = {"NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 4, "NMS_POST_MAXSIZE": 4}
    out = nms_utils.batched_multi_classes_nms(torch.from_numpy(scores), torch.from_numpy(boxes),
                                              torch.ones((1, 4), dtype=torch.bool),
                                              EasyDict(cfg), score_thresh=0.1)
    want = jax.device_get(jax.jit(lambda sc, bx: j_nms_utils.batched_multi_classes_nms(
        sc, bx, jnp.ones((1, 4), bool), JEasyDict(cfg), score_thresh=0.1))(
        jnp.asarray(scores), jnp.asarray(boxes)))
    assert int(out["pred_counts"][0]) == 4
    assert out["pred_labels"][0].tolist() == [1, 1, 2, 2] + [0] * 4
    for k in want:
        np.testing.assert_array_equal(out[k].numpy(), want[k], err_msg=k)


def _candidates(seed=5, N=96, C=3):
    """Clustered, overlapping boxes (some duplicated) and sigmoid scores of
    C classes, some below the threshold."""
    rs = np.random.RandomState(seed)
    boxes = np.stack([_boxes(N, seed + b, spread=4.0) for b in range(B)])
    boxes[:, 10:20] = boxes[:, 0:10] + rs.uniform(-0.2, 0.2, (B, 10, 7)).astype(np.float32)
    boxes[:, 30] = boxes[:, 31]
    logits = rs.randn(B, N, C).astype(np.float32)
    return boxes, logits


def test_batched_multi_classes_nms_equals_jax():
    """96 candidates a frame, three classes, ``NMS_THRESH`` one a class
    (0.1, 0.3, 0.5), PRE 64, POST 16, a validity mask: every output equal
    to JAX's, each class's segment compacted in class order."""
    boxes, logits = _candidates()
    scores = 1 / (1 + np.exp(-logits))
    valid = np.random.RandomState(2).rand(B, boxes.shape[1]) < 0.9
    cfg = {"NMS_THRESH": [0.1, 0.3, 0.5], "NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 16}
    want = jax.device_get(jax.jit(lambda s, b, v: j_nms_utils.batched_multi_classes_nms(
        s, b, v, JEasyDict(cfg), score_thresh=0.3))(jnp.asarray(scores), jnp.asarray(boxes),
                                                    jnp.asarray(valid)))
    got = nms_utils.batched_multi_classes_nms(torch.from_numpy(scores), torch.from_numpy(boxes),
                                              torch.from_numpy(valid), EasyDict(cfg),
                                              score_thresh=0.3)
    assert got["pred_boxes"].shape == (B, 48, 7)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    labels = want["pred_labels"]
    for b in range(B):
        n = int(want["pred_counts"][b])
        assert list(labels[b, :n]) == sorted(labels[b, :n]) and len(set(labels[b, :n])) == 3


def test_iassd_post_processing_multi_class_equals_jax():
    """``iassd.post_processing`` with ``MULTI_CLASSES_NMS`` (the default
    post-processor of every anchor detector and of IASSD) on raw logits:
    one walk a class, each keep mask equal to the plain walk's on the same
    IoU, every output equal to JAX's ``post_processing``, which takes its
    ``batched_multi_classes_nms`` branch."""
    boxes, logits = _candidates(seed=8)
    post_cfg = {"SCORE_THRESH": 0.3, "NMS_CONFIG": {"MULTI_CLASSES_NMS": True,
                                                    "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 64,
                                                    "NMS_POST_MAXSIZE": 16}}
    want = jax.device_get(jax.jit(lambda c, b: j_post(c, b, JEasyDict(post_cfg)))(
        jnp.asarray(logits), jnp.asarray(boxes)))
    keeps = []
    real = nms_utils.greedy_nms_mask_batched

    def walk(iou, valid, thresh):
        keep = real(iou, valid, thresh)
        keeps.append((iou, valid, keep))
        return keep

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nms_utils, "greedy_nms_mask_batched", walk)
        got = post_processing(torch.from_numpy(logits), torch.from_numpy(boxes),
                              EasyDict(post_cfg))
    assert len(keeps) == 3 and all(not k.all() for _, _, k in keeps)
    from pdanet_tpu.ops.nms import greedy_nms_mask_batched as j_walk

    walk_jit = jax.jit(lambda i, v: j_walk(i, v, 0.1))
    for iou, valid, keep in keeps:
        np.testing.assert_array_equal(keep.numpy(), np.asarray(walk_jit(
            jnp.asarray(iou.numpy()), jnp.asarray(valid.numpy()))))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert int(want["pred_counts"].min()) > 0


# ---------------------------------------------------------------- the detector

def multihead_cfg():
    """``test_multihead.py:178``'s SECOND (the dense backbone) over
    separate heads of one class each, its post-processing per class."""
    cfg = copy.deepcopy(dict(SECOND_MODEL_CFG))
    cfg["DENSE_HEAD"] = {**cfg["DENSE_HEAD"], "NAME": "AnchorHeadMulti", "USE_MULTIHEAD": True,
                         "SEPARATE_MULTIHEAD": True, "SHARED_CONV_NUM_FILTER": 16,
                         "RPN_HEAD_CFGS": [{"HEAD_CLS_NAME": ["Car"]},
                                           {"HEAD_CLS_NAME": ["Pedestrian"]}]}
    cfg["POST_PROCESSING"] = {"SCORE_THRESH": 0.1, "NMS_CONFIG": {
        "MULTI_CLASSES_NMS": True, "NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.1,
        "NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 16}}
    return cfg


@pytest.fixture(scope="module")
def batch():
    return make_batch(seed=4)


def _det_gt():
    gt = np.zeros((B, 3, 8), np.float64)
    gt[:, 0] = [3.0, 0.5, -0.8, 3.9, 1.6, 1.56, 0.3, 1]
    gt[0, 1] = [1.5, -1.0, -0.2, 0.8, 0.6, 1.73, -0.5, 2]
    gt[1, 1] = [4.5, 1.0, -0.3, 0.8, 0.6, 1.73, 1.0, 2]
    return gt


@pytest.fixture(scope="module")
def mh_run(batch):
    """The tiny JAX multi-head SECOND on the batch: at eval in float32
    (forward, per-class post-processing) with perturbed weights, and in
    training mode in float64 (loss, gradient, the statistics)."""
    cfg = EasyDict(multihead_cfg())
    jmodel = j_build(JEasyDict(multihead_cfg()), num_class=2, input_channels=4, **GEOMETRY)
    args = _args(batch)
    variables = _perturb(jax.jit(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a))(*args), 6)

    def predict(v, *a):
        out = jmodel.apply(v, *a, train=False)
        out.pop("multi_scale_3d_features")
        out.pop("head_outs")
        return out, j_post(out["batch_cls_preds"], out["batch_box_preds"],
                           JEasyDict(cfg.POST_PROCESSING))

    out, post = jax.device_get(jax.jit(predict)(variables, *args))
    with _exact_f64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        a64 = _args(batch, jnp.float64)

        def loss_fn(params, gt_):
            o, mut = jmodel.apply({"params": params, "batch_stats": v64["batch_stats"]}, *a64,
                                  train=True, mutable=["batch_stats"])
            loss, tb = jmodel.apply(v64, o, gt_, list(CLASSES), method=jmodel.loss)
            return loss, (tb, mut["batch_stats"])

        (loss, (tb, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], jnp.asarray(_det_gt()))
        f64 = dict(variables=v64, loss=float(loss), tb={k: float(x) for k, x in tb.items()},
                   grads=jax.device_get(grads), stats=jax.device_get(stats))
    model = build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY).eval()
    load_jax_variables(model, variables)
    return dict(cfg=cfg, variables=variables, out=out, post=post, f64=f64, model=model)


def test_second_multihead_eval_matches_jax(batch, mh_run):
    """Eval in float32: two heads of 32 anchors, the separate heads' other
    class at -1e9, the logits and boxes within 2e-3, and the per-class
    detections (2 x 16 slots) paired box for box with JAX's."""
    model, want = mh_run["model"], mh_run["out"]
    with torch.no_grad():
        out = model.forward_batch(_tb(batch))
        post = get_post_processor("SECOND")(out, mh_run["cfg"])
    assert out["batch_cls_preds"].shape == (B, 64, 2) and len(out["head_outs"]) == 2
    assert out["cls_preds"][:, :32, 1].max().item() <= -1e8
    for key in ("cls_preds", "box_preds", "dir_cls_preds", "batch_box_preds"):
        err = np.abs(out[key].numpy() - want[key]).max()
        assert err <= 2e-3, (key, err)
    post = {k: v.numpy() for k, v in post.items()}
    assert post["pred_boxes"].shape == (B, 32, 7) and post["pred_counts"].min() > 0
    assert set(np.unique(post["pred_labels"][0, :post["pred_counts"][0]])) == {1, 2}
    box_err, score_err = _match(post, mh_run["post"])
    assert box_err <= 1e-3 and score_err <= 1e-4


def test_second_multihead_loss_and_gradients_match_jax_float64(batch, mh_run):
    """Training mode in float64: the loss and its tb terms (the per-head
    focal terms, box and direction) within 1e-10 relative, every gradient
    leaf (the dense ladder's and each head's) within 1e-10 of its largest
    |gradient|, the running statistics within 1e-9."""
    f64 = mh_run["f64"]
    model = build_network(mh_run["cfg"], len(CLASSES), device="cpu", **GEOMETRY).double()
    load_jax_variables(model, f64["variables"])
    model.train()
    tb_batch = _tb(batch, torch.float64)
    tb_batch["gt_boxes"] = torch.from_numpy(_det_gt())
    loss, tb = model.loss_batch(model.forward_batch(tb_batch), tb_batch)
    loss.backward()
    assert abs(loss.item() - f64["loss"]) <= 1e-10 * abs(f64["loss"])
    assert tb["rpn_loss_loc"] > 0 and tb["rpn_loss_dir"] > 0
    for k, w in f64["tb"].items():
        assert abs(float(tb[k].detach()) - w) <= 1e-10 * max(abs(w), 1e-3), k
    ref = build_network(mh_run["cfg"], len(CLASSES), device="cpu", **GEOMETRY).double()
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
    assert any(n.startswith("dense_head.head_1") for _, n in worst)
    _stats_close(model, f64["stats"], atol=1e-9)


def test_second_multihead_exported_program_equals_eager(batch, mh_run, tmp_path):
    """The tiny multi-head program (dense ladder, heads, per-class NMS)
    traced by ``torch.export``, saved and reloaded, gives the eager
    closure's outputs exactly."""
    model, cfg = mh_run["model"], mh_run["cfg"]
    dev_batch = _tb(batch)
    exported = serving.export_serving(model, cfg, dev_batch)
    path = tmp_path / "second_multihead_b2.pt2"
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


def test_build_network_second_multihead_yaml():
    """The shipped yaml at full width, its grid from the dataset: the dense
    ``VoxelBackBone8x``, three separate heads of one class (70400 anchors
    each, 211200 in all, the flat anchors equal to JAX's), the per-class
    NMS configured; every leaf of a JAX tree of the same config consumed."""
    cfg = cfg_from_yaml_file(str(YAML))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert type(model).__name__ == "SECOND" and model.head_groups == [[0], [1], [2]]
    assert model.head_anchor_counts == [70400] * 3 and model.anchors_flat.shape == (211200, 7)
    assert model.backbone_3d.num_bev_features == 256
    assert cfg.MODEL.POST_PROCESSING.NMS_CONFIG.MULTI_CLASSES_NMS
    per_class = [getattr(model, f"anchors_class_{i}").numpy() for i in range(3)]
    j_flat, _ = JAHM.multihead_flat_anchors(per_class, model.head_groups)
    np.testing.assert_array_equal(model.anchors_flat.numpy(), np.asarray(j_flat))
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=3, dataset=jds)
    spec = serving.serving_input_spec(cfg, 1, model)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *(jnp.zeros(s, jnp.float32 if d == torch.float32 else jnp.int32)
                                 for s, d in spec.values()), train=False))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rs.rand(*s.shape).astype(np.float32), shapes)
    assert set(variables["params"]["dense_head"]) == {"shared_conv", "shared_bn", "head_0",
                                                      "head_1", "head_2"}
    load_jax_variables(model, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    assert model.dense_head.head_2.conv_cls.weight.shape == (2, 64, 1, 1)
