"""The ONCE slice of pdanet_tpu_torch against the JAX package, on the CPU.

* The ``ver1`` / ``ver2`` vote losses against
  ``contextual_vote_loss_ver1/_ver2`` in float64, with empty instances, an
  all-background frame and the 128-box gt cap: losses within 1e-10
  relative, gradients against ``jax.grad`` within 1e-10 of the largest.
* A tiny ONCE config (``tests/model_cfg.tiny_model_cfg(num_class=5)`` with
  ONCE's head: three SA5 radii, ``use_mean_size: False``, ``ver2``,
  ``dir_weight`` 2.0) in both packages with the same weights: the forward
  with JAX's sampling and ball-query indices fed (xyz 1e-5, centre
  features 1e-3, cls/box logits 2e-3), then free-running (indices and
  detections equal); one float64 train step with the indices fed, its
  loss within 1e-6 relative; the weight bridge consumes every leaf.
* ``cfg_from_yaml_file`` on the ONCE yaml equals the JAX loader's.
* ``boxes_iou3d`` and ``generate_recall_record`` within 1e-6.
* ``eval_one_epoch`` on the mini-ONCE val split (``tests/once_fixture.py``)
  with JAX's weights: recall counts equal, detections matched box for box
  (the margin reported), the ONCE AP dict equal.
"""

import copy
import logging
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from model_cfg import tiny_model_cfg
from once_fixture import build_mini_once
from pdanet_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from pdanet_tpu.datasets import build_dataloader as j_build_dataloader
from pdanet_tpu.datasets.once.once_dataset import create_once_infos as j_create_once_infos
from pdanet_tpu.eval.eval_utils import eval_one_epoch as j_eval_one_epoch
from pdanet_tpu.models.dense_heads import iassd_head as j_head
from pdanet_tpu.models.detectors import build_network as j_build
from pdanet_tpu.models.detectors.iassd import generate_recall_record as j_recall_record
from pdanet_tpu.models.detectors.iassd import post_processing as j_post
from pdanet_tpu.ops.ball_query import ball_query_multi as j_ball_query_multi
from pdanet_tpu.ops.rotated_iou import boxes_iou3d as j_boxes_iou3d
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets import build_dataloader
from pdanet_tpu_torch.eval.eval_utils import eval_one_epoch
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d import iassd_backbone
from pdanet_tpu_torch.models.dense_heads import iassd_head
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.models.detectors.iassd import generate_recall_record
from pdanet_tpu_torch.ops.rotated_iou import boxes_iou3d
from pdanet_tpu_torch.train import build_optimizer_and_schedule, make_train_step
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables

REPO = Path(__file__).resolve().parent.parent
ONCE_YAML = REPO / "tools" / "cfgs" / "once_models" / "PDA-SSD.yaml"
CLASSES = ["Car", "Bus", "Truck", "Pedestrian", "Cyclist"]
NUM_CLASS = 5
EVAL_POINTS = 512  # sample_points budget of the mini-ONCE frames here


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def once_tiny_cfg():
    """The tiny model with ONCE's head and SA5 (three radii)."""
    cfg = EasyDict(tiny_model_cfg(NUM_CLASS))
    sa = cfg.BACKBONE_3D.SA_CONFIG
    sa.RADIUS_LIST[5] = [4.8, 8.4, 12.8]
    sa.NSAMPLE_LIST[5] = [4, 8, 8]
    sa.MLPS[5] = [[64, 64, 128]] * 3
    once = cfg_from_yaml_file(str(ONCE_YAML)).MODEL.POINT_HEAD
    coder = cfg.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG
    coder.use_mean_size = False
    coder.mean_size = once.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size
    cfg.POINT_HEAD.LOSS_CONFIG.LOSS_VOTE_TYPE = "ver2"
    cfg.POINT_HEAD.LOSS_CONFIG.LOSS_WEIGHTS.dir_weight = 2.0
    return cfg


def _perturbed(variables, seed=3):
    """Weights off flax's init: BN statistics and biases away from 0/1."""
    rs = np.random.RandomState(seed)

    def perturb(path, a):
        leaf = path[-1].key
        if leaf == "var":
            return rs.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if leaf in ("mean", "bias"):
            return rs.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        if leaf == "scale":
            return rs.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))


def _cloud_and_gt(seed, B=2, N=256, M=128):
    """Points around five boxes, one per class, with the gt padded to the
    collate cap M."""
    rs = np.random.RandomState(seed)
    rows = np.array([[2.0, 1.0, 0.0, 4.4, 1.9, 1.6, 0.3, 1],
                     [-4.0, 3.0, 0.5, 11.1, 2.9, 3.4, -0.5, 2],
                     [5.0, -5.0, 0.3, 7.5, 2.5, 2.6, 1.1, 3],
                     [-2.0, -3.0, 0.0, 0.7, 0.7, 1.7, 0.0, 4],
                     [0.0, 5.0, 0.0, 2.2, 0.8, 1.4, 2.0, 5]], np.float32)
    pts = np.concatenate([rs.uniform(-8, 8, (B, N, 3)), rs.rand(B, N, 1)], -1).astype(np.float32)
    gt = np.zeros((B, M, 8), np.float32)
    for b in range(B):
        g = rows + rs.randn(5, 8).astype(np.float32) * np.array(
            [0.3, 0.3, 0.05, 0, 0, 0, 0.1, 0], np.float32)
        gt[b, :5] = g
        per_box = N // 8
        for m in range(5):
            pts[b, m * per_box:(m + 1) * per_box, :3] = (
                g[m, 0:3] + (rs.rand(per_box, 3) - 0.5) * g[m, 3:6] * 0.6)
    return pts, gt


def _indices(cfg, inter, enc_xyz):
    """The sampling indices captured from a JAX run, and its ball-query
    indices recomputed on its coordinates, per SA layer."""
    sa_cfg = cfg.BACKBONE_3D.SA_CONFIG
    samp, ball = [], []
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        s = b = None
        if sa_cfg.LAYER_TYPE[k] == "SA_Layer":
            s = inter[f"SA_modules_{k}"]["__call__"][0][3]
            s = None if s is None else np.asarray(s)
            if sa_cfg.RADIUS_LIST[k]:
                b = [np.asarray(i) for i in j_ball_query_multi(
                    tuple(sa_cfg.RADIUS_LIST[k]), tuple(sa_cfg.NSAMPLE_LIST[k]),
                    jnp.asarray(enc_xyz[sa_cfg.LAYER_INPUT[k]]), jnp.asarray(enc_xyz[k + 1]))]
        samp.append(s)
        ball.append(b)
    return samp, ball


def _feed(monkeypatch, model, samp, ball):
    """Feed the JAX run's indices to the port, in call order."""
    samp = [s for s, f in zip(samp, model.backbone_3d.fps_identity)
            if s is not None and not f]
    ball = [b for b in ball if b is not None]
    monkeypatch.setattr(iassd_backbone, "run_sampling",
                        lambda *a: torch.tensor(samp.pop(0)).long())
    monkeypatch.setattr(iassd_backbone, "ball_query_multi",
                        lambda r, n, xyz, c: tuple(torch.tensor(i).long() for i in ball.pop(0)))
    return samp, ball


@pytest.fixture(scope="module")
def jax_once():
    """The tiny ONCE model in JAX: perturbed weights, one float32 eval
    forward with its indices and detections, and one float64 train-mode
    loss with its indices."""
    cfg = once_tiny_cfg()
    points, gt = _cloud_and_gt(17)
    jmodel = j_build(cfg, num_class=NUM_CLASS)
    variables = _perturbed(jax.jit(lambda p: jmodel.init(jax.random.PRNGKey(0), p, train=False))(
        jnp.asarray(points)))
    out, state = jax.jit(lambda v, p: jmodel.apply(
        v, p, train=False, capture_intermediates=True, mutable=["intermediates"]))(
            variables, jnp.asarray(points))
    samp, ball = _indices(cfg, state["intermediates"]["backbone_3d"],
                          [np.asarray(t) for t in out["encoder_xyz"]])
    post = jax.device_get(jax.jit(lambda c, b: j_post(c, b, cfg.POST_PROCESSING))(
        out["batch_cls_preds"], out["batch_box_preds"]))
    run = dict(cfg=cfg, points=points, gt=gt, variables=variables, out=jax.device_get(out),
               post=post, samp=samp, ball=ball)

    jax.config.update("jax_enable_x64", True)
    try:
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def fwd_loss(mdl, pts, gt_):
            out = mdl(pts, train=True)
            return mdl.loss(out, gt_), out

        ((loss, _), out), mut = jax.jit(lambda v, p, g: jmodel.apply(
            v, p, g, mutable=["batch_stats", "intermediates"], method=fwd_loss,
            capture_intermediates=lambda mdl, _m: (mdl.name or "").startswith("SA_modules")))(
                v64, jnp.asarray(points, jnp.float64), jnp.asarray(gt, jnp.float64))
        samp64, ball64 = _indices(cfg, mut["intermediates"]["backbone_3d"],
                                  [np.asarray(t) for t in out["encoder_xyz"]])
        run.update(v64=v64, loss64=float(loss), samp64=samp64, ball64=ball64)
    finally:
        jax.config.update("jax_enable_x64", False)
    return run


def _port(run):
    model = build_network(run["cfg"], NUM_CLASS, device="cpu").eval()
    load_jax_variables(model, run["variables"])
    return model


def _forward(model, run):
    with torch.no_grad():
        out = model(torch.from_numpy(run["points"]))
        post = get_post_processor("IASSD")(out, run["cfg"])
    return out, post


def _compare(run, out, post):
    j = run["out"]
    sa_cfg = run["cfg"].BACKBONE_3D.SA_CONFIG
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        np.testing.assert_allclose(out["encoder_xyz"][k + 1].numpy(),
                                   np.asarray(j["encoder_xyz"][k + 1]), atol=1e-5,
                                   err_msg=f"xyz L{k}")
    np.testing.assert_allclose(out["centers"].numpy(), np.asarray(j["centers"]), atol=1e-5)
    np.testing.assert_allclose(out["centers_features"].numpy(),
                               np.asarray(j["centers_features"]), atol=1e-3)
    np.testing.assert_allclose(out["batch_cls_preds"].numpy(),
                               np.asarray(j["batch_cls_preds"]), atol=2e-3)
    np.testing.assert_allclose(out["center_box_preds"].numpy(),
                               np.asarray(j["center_box_preds"]), atol=2e-3)
    jp = run["post"]
    assert jp["pred_counts"].min() > 0
    np.testing.assert_array_equal(post["pred_counts"].numpy(), jp["pred_counts"])
    np.testing.assert_allclose(post["pred_boxes"].numpy(), jp["pred_boxes"], atol=1e-4)
    np.testing.assert_allclose(post["pred_scores"].numpy(), jp["pred_scores"], atol=1e-4)
    np.testing.assert_array_equal(post["pred_labels"].numpy(), jp["pred_labels"])


def test_once_forward_with_jax_indices(jax_once, monkeypatch):
    model = _port(jax_once)
    samp, ball = _feed(monkeypatch, model, jax_once["samp"], jax_once["ball"])
    out, post = _forward(model, jax_once)
    assert not samp and not ball
    _compare(jax_once, out, post)


def test_once_forward_free_running(jax_once):
    out, post = _forward(_port(jax_once), jax_once)
    sa_cfg = jax_once["cfg"].BACKBONE_3D.SA_CONFIG
    for k, (js, jb) in enumerate(zip(jax_once["samp"], jax_once["ball"])):
        if js is not None:
            msg = f"sampled idx L{k}"
            if "ctr_aware" in sa_cfg.SAMPLE_METHOD_LIST[k]:
                # the ctr-aware cut must not sit on a near tie of the scores
                cls = np.asarray(jax_once["out"]["sa_ins_preds"][k - 1])
                score = np.sort(1 / (1 + np.exp(-cls.max(-1))), axis=-1)[:, ::-1]
                npoint = sa_cfg.NPOINT_LIST[k][0]
                gap = (score[:, npoint - 1] - score[:, npoint]).min()
                msg += f" (top-k score gap at the cut {gap:.3g})"
                assert gap > 1e-5, msg
            np.testing.assert_array_equal(out["sampled_idx"][k].numpy(), js, err_msg=msg)
        if jb is not None:
            assert len(jb) == len(sa_cfg.RADIUS_LIST[k])
            for r, (g, w) in enumerate(zip(out["ball_query_idx"][k], jb)):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"ball L{k} r{r}")
    _compare(jax_once, out, post)


def test_once_weight_bridge_consumes_every_leaf(jax_once):
    model = _port(jax_once)
    assert len(jax.tree_util.tree_leaves(jax_once["variables"])) == len(model.state_dict())
    short = jax.tree_util.tree_map(lambda a: a, jax_once["variables"])
    del short["params"]["backbone_3d"]["SA_modules_5"]["mlps_2"]
    with pytest.raises(KeyError):
        load_jax_variables(build_network(jax_once["cfg"], NUM_CLASS, device="cpu"), short)


def test_once_train_step_float64_like_jax(jax_once, monkeypatch):
    """One ver2 train step in float64 with JAX's indices fed; gt padded to
    the 128-box cap, so the vote loss bins over B x 128 instances."""
    cfg = jax_once["cfg"]
    model = build_network(cfg, NUM_CLASS, device="cpu").double()
    load_jax_variables(model, jax_once["v64"])
    optim = EasyDict(dict(OPTIMIZER="adam_onecycle", LR=0.01, WEIGHT_DECAY=0.01,
                          MOMS=[0.95, 0.85], PCT_START=0.4, DIV_FACTOR=10, GRAD_NORM_CLIP=10))
    optimizer, schedule = build_optimizer_and_schedule(model, optim, 2, 4)
    samp, ball = _feed(monkeypatch, model, jax_once["samp64"], jax_once["ball64"])
    loss, tb = make_train_step(model, optimizer, schedule)({
        "points": torch.tensor(jax_once["points"], dtype=torch.float64),
        "gt_boxes": torch.tensor(jax_once["gt"], dtype=torch.float64)})
    assert not samp and not ball
    assert float(tb["vote_loss"]) > 0
    rel = abs(loss.item() - jax_once["loss64"]) / abs(jax_once["loss64"])
    assert rel <= 1e-6, f"loss {loss.item()!r} against JAX {jax_once['loss64']!r}: {rel:.3g}"
    assert optimizer.count == 1


# ---------------------------------------------------------------------------
# the vote losses
# ---------------------------------------------------------------------------


def _vote_inputs(case):
    """(forward dict, num_boxes) in float64.  Every case has boxes that no
    point falls in (empty instances)."""
    rs = np.random.RandomState({"mixed": 1, "background_frame": 2, "cap128": 3,
                                "all_background": 4}[case])
    B, N, M = (2, 256, 128) if case == "cap128" else (3, 64, 6)
    idx = rs.randint(-1, M // 2, (B, N))
    if case == "cap128":
        idx[0, :8] = M - 1  # the last bin of the cap
    if case == "background_frame":
        idx[1] = -1
    if case == "all_background":
        idx[:] = -1
    gt = np.zeros((B, N, 8))
    gt[..., 0:3] = rs.randn(B, N, 3) * 3
    ret = {"center_origin_box_idxs_of_pts": idx.astype(np.int32),
           "gt_box_of_center_origin": gt,
           "centers_origin": rs.randn(B, N, 3) * 3,
           "ctr_offsets": rs.randn(B, N, 3) * 1.5}
    return ret, M


@pytest.mark.parametrize("case", ["mixed", "background_frame", "cap128", "all_background"])
@pytest.mark.parametrize("ver", ["ver1", "ver2"])
def test_vote_loss_matches_jax(ver, case):
    ret, M = _vote_inputs(case)
    weight = 1.7
    port_fn = getattr(iassd_head, f"contextual_vote_loss_{ver}")
    j_fn = getattr(j_head, f"contextual_vote_loss_{ver}")
    t = {k: torch.tensor(v) for k, v in ret.items()}
    for k in ("centers_origin", "ctr_offsets"):
        t[k].requires_grad_(True)
    loss = port_fn(t, M, weight)
    loss.backward()
    jax.config.update("jax_enable_x64", True)
    try:
        def jloss(co, off):
            return j_fn(dict(ret, centers_origin=co, ctr_offsets=off), M, weight)

        j_loss, j_grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
            jnp.asarray(ret["centers_origin"]), jnp.asarray(ret["ctr_offsets"]))
        j_loss, j_grads = float(j_loss), [np.asarray(g) for g in j_grads]
    finally:
        jax.config.update("jax_enable_x64", False)
    assert loss.dtype == torch.float64
    if case == "all_background":
        assert loss.item() == 0.0 == j_loss
    else:
        assert j_loss > 0
        assert abs(loss.item() - j_loss) <= 1e-10 * abs(j_loss), (loss.item(), j_loss)
    for k, jg in zip(("centers_origin", "ctr_offsets"), j_grads):
        g = t[k].grad.numpy()
        scale = max(np.abs(jg).max(), 1e-300)
        assert np.abs(g - jg).max() <= 1e-10 * scale, k


def test_vote_loss_ver2_spread_gradient_flows_through_the_means():
    """ver2 minus ver1 is the spread term; its gradient is not that of the
    spread with the means held fixed."""
    ret, M = _vote_inputs("mixed")
    off = torch.tensor(ret["ctr_offsets"], requires_grad=True)
    t = dict({k: torch.tensor(v) for k, v in ret.items()}, ctr_offsets=off)
    spread = (iassd_head.contextual_vote_loss_ver2(t, M, 1.0)
              - iassd_head.contextual_vote_loss_ver1(t, M, 1.0))
    (g,) = torch.autograd.grad(spread, off)
    assert spread.item() > 0
    grads = g.reshape(-1, 3)[torch.tensor(ret["center_origin_box_idxs_of_pts"]).reshape(-1) >= 0]
    # a spread whose means were detached would not sum to zero per instance
    idx = torch.tensor(ret["center_origin_box_idxs_of_pts"])
    seg = (torch.arange(idx.shape[0])[:, None] * M + idx).reshape(-1)[idx.reshape(-1) >= 0]
    per_ins = torch.zeros(idx.shape[0] * M, 3, dtype=g.dtype).index_add_(0, seg, grads)
    assert per_ins.abs().max().item() < 1e-12 * grads.abs().max().item() + 1e-15


# ---------------------------------------------------------------------------
# config, 3-D IoU and the recall record
# ---------------------------------------------------------------------------


def test_once_config_loader_matches_jax():
    want = j_cfg_from_yaml_file(str(ONCE_YAML), JEasyDict())
    got = cfg_from_yaml_file(str(ONCE_YAML))
    assert got == want
    assert got.MODEL.POINT_HEAD.LOSS_CONFIG.LOSS_VOTE_TYPE == "ver2"
    assert got.DATA_CONFIG.MAX_GT_BOXES == 128


def _boxes(rs, n, span=8.0):
    return np.concatenate([rs.uniform(-span, span, (n, 2)), rs.uniform(-1, 1, (n, 1)),
                           rs.uniform(0.5, 5, (n, 3)), rs.uniform(-np.pi, np.pi, (n, 1))],
                          axis=1).astype(np.float32)


def test_boxes_iou3d_and_recall_record_match_jax():
    rs = np.random.RandomState(5)
    B, P, M = 2, 60, 24
    gt = np.zeros((B, M, 8), np.float32)
    preds, valid = [], []
    for b in range(B):
        gt[b, :15, :7] = _boxes(rs, 15)
        gt[b, :15, 7] = rs.randint(1, 6, 15)
        jitter = gt[b, rs.randint(0, 15, P), :7] + rs.normal(0, 0.3, (P, 7)).astype(np.float32)
        preds.append(np.concatenate([jitter[:40], _boxes(rs, P - 40)]))
        valid.append(np.arange(P) < 50)
    preds, valid = np.stack(preds), np.stack(valid)
    thresh = [0.3, 0.5, 0.7]
    for b in range(B):
        got = boxes_iou3d(torch.from_numpy(preds[b]), torch.from_numpy(gt[b, :, :7])).numpy()
        want = np.asarray(j_boxes_iou3d(jnp.asarray(preds[b]), jnp.asarray(gt[b, :, :7])))
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert (want > 0.5).sum() > 10
        got = generate_recall_record(torch.from_numpy(preds[b]), torch.from_numpy(valid[b]),
                                     torch.from_numpy(gt[b]), thresh)
        want = j_recall_record(jnp.asarray(preds[b]), jnp.asarray(valid[b]),
                               jnp.asarray(gt[b]), thresh)
        for k, v in got.items():
            assert int(v) == int(want[k]), k
    batched = generate_recall_record(torch.from_numpy(preds), torch.from_numpy(valid),
                                     torch.from_numpy(gt), thresh)
    assert batched["gt"].tolist() == [15, 15] and batched["rcnn_0.3"].shape == (B,)


# ---------------------------------------------------------------------------
# eval_one_epoch on the mini-ONCE val split
# ---------------------------------------------------------------------------


def test_eval_one_epoch_matches_jax(jax_once, tmp_path):
    root = tmp_path / "mini_once"
    build_mini_once(root, num_frames=3)
    cfg = cfg_from_yaml_file(str(ONCE_YAML))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": EVAL_POINTS, "test": EVAL_POINTS}
    cfg.MODEL = jax_once["cfg"]
    cfg.MODEL.POST_PROCESSING.SCORE_THRESH = 0.01  # the ONCE yaml's
    cfg.MODEL.POST_PROCESSING.RECALL_THRESH_LIST = [0.0, 0.01, 0.3]
    j_cfg = JEasyDict(copy.deepcopy(dict(cfg)))
    logger = logging.getLogger("test_torch_once")
    j_create_once_infos(j_cfg.DATA_CONFIG, list(CLASSES), root, root, workers=1)
    # random weights place no box near the fixture's gt: widen the val
    # gt to 40 x 40 x 6 m, so that the recall counts are not all 0
    with open(root / "once_infos_val.pkl", "rb") as f:
        infos = pickle.load(f)
    for info in infos:
        info["annos"]["boxes_3d"][:, 3:6] = [40.0, 40.0, 6.0]
    with open(root / "once_infos_val.pkl", "wb") as f:
        pickle.dump(infos, f)
    _, j_loader, _ = j_build_dataloader(j_cfg.DATA_CONFIG, list(CLASSES), 1,
                                        root_path=root, workers=0, training=False)
    jmodel = j_build(j_cfg.MODEL, num_class=NUM_CLASS)
    np.random.seed(0)  # sample_points subsamples the test split too
    want = j_eval_one_epoch(j_cfg, jmodel, jax_once["variables"], j_loader, 0, logger,
                            result_dir=tmp_path / "jax")
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, list(CLASSES), 1,
                                    root_path=root, workers=0, training=False)
    np.random.seed(0)
    got = eval_one_epoch(cfg, _port(jax_once), loader, 0, logger,
                         result_dir=tmp_path / "port", device="cpu")
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k] == w, (k, got[k], w)
    print({k: round(float(v), 3) for k, v in want.items()})
    assert want["recall/rcnn_0.0"] > 0 and "AP_mean/overall" in want

    with open(tmp_path / "jax" / "result.pkl", "rb") as f:
        j_annos = pickle.load(f)
    with open(tmp_path / "port" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert len(annos) == len(j_annos) == 3
    margin = 0.0
    for a, w in zip(annos, j_annos):
        assert a["frame_id"] == w["frame_id"]
        assert len(a["score"]) == len(w["score"]) > 0
        # each JAX box matched by the port's box of the same rank, name and score
        np.testing.assert_array_equal(a["name"], w["name"])
        np.testing.assert_allclose(a["score"], w["score"], atol=1e-4)
        err = np.abs(np.asarray(a["boxes_3d"]) - np.asarray(w["boxes_3d"])).max()
        margin = max(margin, err)
    print(f"eval_one_epoch: largest |port - JAX| box coordinate {margin:.3g}")
    assert margin <= 1e-4, f"largest box difference {margin:.3g}"
