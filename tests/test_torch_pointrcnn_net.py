"""``PointRCNN`` of pdanet_tpu_torch against the JAX package's, on the CPU,
at ``tests/test_pointrcnn.py``'s tiny config over two frames of 256 points
(``test_torch_pointrcnn.py`` holds the ops, the backbone and the RoI head):

* at eval in float32: the backbone's FPS and ball-query indices equal to
  JAX's ops on the same levels, the RoI head's on the port's pooled clouds,
  the RoIs, labels and validity equal, logits within 2e-3, detections
  paired box for box;
* in training mode in float64, JAX's sampler draws fed: loss within 1e-10
  relative, gradients within 1e-10 of each leaf's scale, statistics within
  1e-9;
* ``pointrcnn_iou.yaml``'s ``roi_iou`` labels within 1e-5 of JAX's on the
  same proposals and draws;
* the exported program equal to the eager closure.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.detectors import voxel_rcnn as j_vrcnn
from pdanet_tpu.models.roi_heads import roi_head_template as JRHT
from pdanet_tpu.ops import ball_query as j_bq
from pdanet_tpu.ops import sampling as j_sampling
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d import pointnet2_backbone as pn2
from pdanet_tpu_torch.models.blocks import init_random_weights
from pdanet_tpu_torch.models.dense_heads.point_head_box import generate_predicted_boxes
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.models.roi_heads import pointrcnn_head as prh
from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT
from pdanet_tpu_torch.ops.rotated_iou import boxes_iou3d
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_parta2 import _gt_near, random_variables
from test_torch_pointpillar import _match, _stats_close
from test_torch_pointrcnn import B, CLASSES, N, YAMLS, _Record, make_points, pointrcnn_cfg
from test_torch_second import _exact_f64
from test_torch_voxel_rcnn import FEED_KEY, _stack_draws, jax_sampler_draws


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _first_stage_proposals(model, pts):
    """The training-mode proposals of ``model``'s first stage in float64, on
    a copy."""
    probe = copy.deepcopy(model).double().train()
    with torch.no_grad():
        bb = probe.backbone_3d(torch.from_numpy(pts).double())
        cls, box = probe.point_head(bb["point_features"])
        _, boxes = generate_predicted_boxes(bb["point_coords"], cls, box, probe.point_box_coder)
        return RHT.proposal_layer(cls, boxes, probe.roi_cfg.NMS_CONFIG.TRAIN)


@pytest.fixture(scope="module")
def pointrcnn_run():
    """The tiny JAX PointRCNN on two frames: at eval in float32 (forward and
    the refined post-processing) with random weights, and in training mode
    in float64 (loss, gradient, statistics and proposals, its sampler
    drawing from ``FEED_KEY``), the gt near the training RoIs.  One compile
    each."""
    cfg = EasyDict(pointrcnn_cfg())
    jmodel = j_build(JEasyDict(cfg), num_class=2, input_channels=4, class_names=CLASSES)
    pts = make_points()
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       random_variables(jmodel, (jnp.asarray(pts),), 3))

    def predict(v, p):
        out = jmodel.apply(v, p, train=False)
        return out, j_vrcnn.post_processing(out, JEasyDict(cfg))

    out, post = jax.device_get(jax.jit(predict)(variables, jnp.asarray(pts)))
    model = build_network(cfg, 2, device="cpu").eval()
    load_jax_variables(model, variables)
    props = _first_stage_proposals(model, pts)
    gt = _gt_near(*(props[k].numpy() for k in ("rois", "roi_labels", "roi_valid")),
                  pts[..., :3].astype(np.float64))
    orig = JRHT.assign_targets

    def assign(rng, proposals, gt_boxes, sampler_cfg):
        t = orig(jax.random.PRNGKey(FEED_KEY), proposals, gt_boxes, sampler_cfg)
        t["_proposals"] = proposals
        return t

    with pytest.MonkeyPatch.context() as mp, _exact_f64():
        mp.setattr(JRHT, "assign_targets", assign)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss_fn(params, gt_, p):
            batch = {"points": p, "gt_boxes": gt_}

            def fwd_loss(mdl, b):
                o = mdl.forward_batch(b, train=True)
                return mdl.loss_batch(o, b), o["roi_targets"]["_proposals"]

            ((loss, tb), props_), mut = jmodel.apply(
                {"params": params, "batch_stats": v64["batch_stats"]}, batch,
                mutable=["batch_stats"], method=fwd_loss,
                rngs={"proposal": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)})
            return loss, (tb, mut["batch_stats"], props_)

        (loss, (tb, stats, jprops)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], jnp.asarray(gt), jnp.asarray(pts, jnp.float64))
        f64 = dict(variables=v64, loss=float(loss), tb={k: float(x) for k, x in tb.items()},
                   grads=jax.device_get(grads), stats=jax.device_get(stats),
                   proposals=jax.device_get(jprops))
    return dict(cfg=cfg, variables=variables, pts=pts, out=out, post=post, gt=gt, f64=f64,
                model=model)


def test_pointrcnn_eval_equals_jax(pointrcnn_run):
    """Eval in float32: the backbone's FPS and ball-query indices equal to
    JAX's ops on the same levels (and the RoI head's on the port's pooled
    clouds), the point logits within 2e-3, the RoIs, labels and validity
    equal, ``rcnn_cls`` within 2e-3, the refined boxes within 1e-3, the
    detections paired box for box."""
    run = pointrcnn_run
    model, want, pts = run["model"], run["out"], run["pts"]
    fps_calls, bq_calls = [], []
    real_fps, real_bq = pn2.farthest_point_sample, pn2.ball_query_multi

    def fps(xyz, npoint):
        out = real_fps(xyz, npoint)
        fps_calls.append((xyz.numpy().copy(), npoint, out.numpy()))
        return out

    def bq(radii, nsamples, xyz, new_xyz, site=""):
        out = real_bq(radii, nsamples, xyz, new_xyz)
        bq_calls.append((radii, nsamples, xyz.numpy().copy(), new_xyz.numpy().copy(),
                         [o.numpy() for o in out]))
        return out

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(pn2, "farthest_point_sample", fps)
        mp.setattr(pn2, "ball_query_multi", bq)
        rec = _Record(mp, prh)
        out = model.forward_batch({"points": torch.from_numpy(pts)})
        post = get_post_processor("PointRCNN")(out, run["cfg"])
    rec.check_against_jax()
    # the backbone's levels: JAX's chain of ops from the same cloud
    xyz = jnp.asarray(pts[..., :3])
    assert [c[1] for c in fps_calls] == [64, 16] and len(bq_calls) == 2
    for (_, npoint, idx), (radii, ks, _, _, qidx) in zip(fps_calls, bq_calls):
        want_idx = j_sampling.farthest_point_sample(xyz, npoint)
        np.testing.assert_array_equal(idx, np.asarray(want_idx))
        new = jnp.take_along_axis(xyz, want_idx[..., None].astype(jnp.int32), axis=1)
        for got_q, want_q in zip(qidx, j_bq.ball_query_multi(tuple(radii), tuple(ks), xyz,
                                                              new)):
            np.testing.assert_array_equal(got_q, np.asarray(want_q))
        xyz = new
    for key, tol in (("point_cls_preds", 2e-3), ("point_box_preds", 2e-3),
                     ("point_cls_scores", 2e-3)):
        assert np.abs(out[key].numpy() - want[key]).max() <= tol, key
    for key in ("roi_labels", "roi_valid"):
        np.testing.assert_array_equal(out[key].numpy(), want[key], err_msg=key)
    assert want["roi_valid"].sum() > 4
    np.testing.assert_allclose(out["rois"].numpy(), want["rois"], atol=1e-4, rtol=0)
    for key, tol in (("rcnn_cls", 2e-3), ("batch_box_preds", 1e-3)):
        assert np.abs(out[key].numpy() - want[key]).max() <= tol, key
    post = {k: v.numpy() for k, v in post.items()}
    assert post["pred_counts"].min() > 0
    box_err, score_err = _match(post, run["post"])
    assert box_err <= 1e-3 and score_err <= 1e-4


def _fed_draws(run, cfg):
    """JAX's sampler draws of the float64 run, from its proposals and gt."""
    props = {k: torch.from_numpy(np.array(v)) for k, v in run["f64"]["proposals"].items()}
    gtt = torch.from_numpy(run["gt"])
    ok = (gtt[..., :7] != 0).any(-1)[:, None, :] & (
        props["roi_labels"][..., None] == gtt[..., 7].int()[:, None, :])
    iou = torch.where(ok, boxes_iou3d(props["rois"], gtt[..., :7]), -1.0)
    mo = torch.where(props["roi_valid"], iou.max(-1).values.clamp(min=0), 0.0)
    R = int(cfg.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE)
    keys = jax.random.split(jax.random.PRNGKey(FEED_KEY), B)
    with _exact_f64():
        frames = [jax_sampler_draws(keys[b], mo[b].numpy(), R, np.float64) for b in range(B)]
    return props, _stack_draws(frames)


def test_pointrcnn_float64_step_equals_jax(pointrcnn_run):
    """The training forward, loss and backward in float64 from the JAX
    weights, the sampler fed JAX's draws: the loss and its tb terms within
    1e-10 relative, every gradient leaf within 1e-10 of its largest
    |gradient|, the running statistics within 1e-9; foreground RoIs
    sampled, the point loss positive, the backbone, point head and RoI head
    trained."""
    run = pointrcnn_run
    f64, cfg = run["f64"], run["cfg"]
    model = build_network(cfg, 2, device="cpu").double()
    load_jax_variables(model, f64["variables"])
    model.train()
    _, sampler = _fed_draws(run, cfg)
    batch = {"points": torch.from_numpy(run["pts"]).double(),
             "gt_boxes": torch.from_numpy(run["gt"])}
    out = model.forward_batch(batch, draws={"sampler": sampler, "dropout": {}})
    loss, tb = model.loss_batch(out, batch)
    loss.backward()
    assert abs(loss.item() - f64["loss"]) <= 1e-10 * abs(f64["loss"])
    assert tb["rcnn_loss_corner"] > 0 and tb["point_pos_num"] > 0
    assert set(tb) == set(f64["tb"])
    for k, w in f64["tb"].items():
        assert abs(float(tb[k].detach()) - w) <= 1e-10 * max(abs(w), 1e-3), k
    ref = build_network(cfg, 2, device="cpu").double()
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


def test_pointrcnn_iou_labels_equal_jax(pointrcnn_run):
    """``pointrcnn_iou.yaml``'s TARGET_CONFIG (``CLS_SCORE_TYPE`` roi_iou,
    thresholds 0.7 / 0.25) on the float64 run's proposals, gt and draws:
    the sampled RoIs equal and the soft labels within 1e-5 of JAX's, some
    strictly between 0 and 1."""
    run = pointrcnn_run
    target = cfg_from_yaml_file(str(YAMLS / "pointrcnn_iou.yaml")).MODEL.ROI_HEAD.TARGET_CONFIG
    assert target.CLS_SCORE_TYPE == "roi_iou"
    target = EasyDict({**target, "ROI_PER_IMAGE": run["cfg"].ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE})
    props, sampler = _fed_draws(run, run["cfg"])
    got = RHT.sample_rois_for_rcnn(props, torch.from_numpy(run["gt"]), target, sampler)
    with _exact_f64():  # the draws of the float64 run
        want = jax.device_get(JRHT.sample_rois_for_rcnn(
            jax.random.PRNGKey(FEED_KEY), jax.tree_util.tree_map(
                jnp.asarray, run["f64"]["proposals"]), jnp.asarray(run["gt"]),
            JEasyDict(target)))
    np.testing.assert_allclose(got["rois"].numpy(), want["rois"], atol=1e-6, rtol=0)
    labels = got["rcnn_cls_labels"].numpy()
    np.testing.assert_allclose(labels, want["rcnn_cls_labels"], atol=1e-5, rtol=0)
    assert ((labels > 0) & (labels < 1)).any() and (labels == 1).any()


def test_pointrcnn_exported_program_equals_eager(tmp_path):
    """The tiny program over seeded weights, traced by ``torch.export`` at
    the points spec (B, N, 4), saved and reloaded: the eager closure's
    outputs exactly."""
    cfg = EasyDict(pointrcnn_cfg())
    model = init_random_weights(build_network(cfg, 2, device="cpu"), 4).eval()
    dev_batch = {"points": torch.from_numpy(make_points(11))}
    full = EasyDict(MODEL=cfg, CLASS_NAMES=list(CLASSES), DATA_CONFIG=EasyDict(
        DATA_PROCESSOR=[EasyDict(NAME="sample_points", NUM_POINTS={"train": N, "test": N})],
        POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z", "intensity"]}))
    assert serving.serving_input_spec(full, B, model) == {"points": ((B, N, 4), torch.float32)}
    exported = serving.export_serving(model, cfg, dev_batch)
    path = tmp_path / "pointrcnn_b2.pt2"
    meta = serving.serving_meta(full, "tiny.yaml", dev_batch, exported)
    assert list(meta["inputs"]) == ["points"]
    serving.save_serving(exported, path, meta)
    predict, _ = serving.load_serving(path)
    got = predict(dev_batch)
    want = serving.make_predict_fn(model, cfg)(dev_batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(want["pred_counts"].min()) > 0
