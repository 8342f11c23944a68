"""pdanet_tpu_torch training against the JAX package, on the CPU.

At the tiny config of ``tests/model_cfg.py``, on numpy inputs handed to
both packages:

* the geometry of target assignment (``in_box_mask`` and
  ``points_in_boxes``, with points on the z faces and 1e-5 inside the xy
  margin) and the box coder's ``encode``: equal masks and indices, codes
  within 1e-6;
* ``assign_targets`` and every tb scalar of the loss stack on one JAX
  forward dict in float32: labels, masks and gathered gt rows equal, each
  scalar within 1e-5 relative;
* the port's BatchNorm in training mode against ``models/norm.BatchNorm``:
  output and running statistics after one step within 1e-5;
* one optimizer update on identical gradients against the optax chain of
  ``adam_onecycle``, within 1e-6, with the clip off and on; ``adam`` and
  ``sgd`` in float64 over six updates across two decay steps and the
  learning-rate floor, parameters within 1e-12 and learning rates equal;
* the slice as a whole: three train steps in float64 with the JAX run's
  sampling and ball-query indices fed in.  The loss agrees at every step
  within 1e-6 relative; parameters and BatchNorm statistics after the
  steps, read back through ``load_jax_variables``, agree within the bounds
  of ``tests/test_train_trajectory_twin.py`` (parameters 2e-3 of the leaf
  scale or the Adam-crumb envelope, statistics 1e-3).  Float64, because a
  float32 trajectory is chaotic (that file, :47-59);
* a resume from the JAX optimizer state after two steps: the third step
  agrees with JAX's third step, within the same bounds;
* bfloat16 train compute against float32 in the port: the loss stays
  within 5 % over six steps (``tests/test_train.py::
  test_bf16_loss_trajectory`` holds the same bound for JAX);
* data parallelism: two Gloo processes, one frame each of the first
  step's batch with its indices fed, against JAX's step on the two-frame
  batch in float64: loss and tb within 1e-6 relative, every gradient leaf
  within 1e-6 of its scale, statistics and parameters after the update
  within the bounds above, the ranks' state bit-equal; without a process
  group no collective runs;
* checkpoints: a round trip restores model and optimizer; a corrupt file
  raises ``CheckpointError``; ``train_one_epoch`` steps once per batch.
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
import optax

from model_cfg import tiny_model_cfg
from pdanet_tpu.models.dense_heads import iassd_head as j_head
from pdanet_tpu.models.detectors import build_network as j_build
from pdanet_tpu.models.norm import BatchNorm as JBatchNorm
from pdanet_tpu.ops import geometry as j_geometry
from pdanet_tpu.ops.ball_query import ball_query_multi as j_ball_query_multi
from pdanet_tpu.train import build_optimizer_and_schedule as j_build_optimizer
from pdanet_tpu.utils.box_coder_utils import build_box_coder as j_build_box_coder
from pdanet_tpu_torch import parallel
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d import iassd_backbone
from pdanet_tpu_torch.models.blocks import BatchNorm, init_random_weights
from pdanet_tpu_torch.models.dense_heads import iassd_head
from pdanet_tpu_torch.ops import geometry
from pdanet_tpu_torch.train import (
    CheckpointError,
    build_optimizer_and_schedule,
    checkpoint_state,
    load_checkpoint,
    make_train_step,
    restore_from_checkpoint,
    save_checkpoint,
    train_one_epoch,
)
from pdanet_tpu_torch.utils.box_coder_utils import build_box_coder
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import (
    load_jax_optimizer_state,
    load_jax_variables,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)

REPO = Path(__file__).resolve().parent.parent
NUM_CLASS = 3
N_STEPS = 3
ITERS_PER_EPOCH, EPOCHS = 2, 4


def _optim_cfg():
    return EasyDict(dict(OPTIMIZER="adam_onecycle", LR=0.01, WEIGHT_DECAY=0.01,
                         MOMS=[0.95, 0.85], PCT_START=0.4, DIV_FACTOR=10,
                         GRAD_NORM_CLIP=10))


def _batch(seed, B=2, N=128):
    """A cloud with two thirds of its points inside three gt boxes (one per
    class), so that the final centres, too, have positives."""
    rs = np.random.RandomState(seed)
    rows = np.array([
        [2.0, 1.0, 0.0, 3.9, 1.6, 1.56, 0.3, 1.0],
        [-3.0, 2.0, 0.2, 0.8, 0.6, 1.73, -0.5, 2.0],
        [0.0, -3.0, -0.2, 1.76, 0.6, 1.73, 1.1, 3.0],
    ], np.float32)
    pts = rs.randn(B, N, 4).astype(np.float32) * 2.0
    gt = np.zeros((B, 3, 8), np.float32)
    for b in range(B):
        g = rows + rs.randn(3, 8).astype(np.float32) * np.array(
            [0.3, 0.3, 0.05, 0, 0, 0, 0.1, 0], np.float32)
        gt[b] = g
        per_box = 2 * N // 9
        for m in range(3):
            inside = g[m, 0:3] + (rs.rand(per_box, 3) - 0.5) * g[m, 3:6] * 0.6
            pts[b, m * per_box:(m + 1) * per_box, :3] = inside
    return pts[:, rs.permutation(N)], gt


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _adam_state(opt_state):
    """(mu, nu, count) of the optax adam_onecycle chain's state."""
    adam = opt_state[1].inner_state
    return _np(adam.mu), _np(adam.nu), int(adam.count)


# ---------------------------------------------------------------------------
# the JAX run: three float64 train steps of the tiny model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX train steps in float64 from perturbed weights, with each
    step's forward dict, loss, tb scalars, gradients, sampling and
    ball-query indices, and the state before each step."""
    cfg = EasyDict(tiny_model_cfg(NUM_CLASS))
    sa_cfg = cfg.BACKBONE_3D.SA_CONFIG
    batches = [_batch(11 + i) for i in range(N_STEPS)]
    jax.config.update("jax_enable_x64", True)
    try:
        model = j_build(cfg, num_class=NUM_CLASS)
        variables = model.init(jax.random.PRNGKey(0), jnp.asarray(batches[0][0]),
                               train=False)
        rs = np.random.RandomState(3)

        def perturb(path, a):
            # norm biases off zero, so that no ReLU sits on its kink
            # (tests/test_train_trajectory_twin.py:498-512)
            keys = [getattr(p, "key", "") for p in path]
            a = np.asarray(a, np.float64)
            norm = any(str(k).startswith(("bn", "norm")) for k in keys)
            if norm and keys[-1] == "bias":
                return rs.uniform(-0.3, 0.3, a.shape)
            if norm and keys[-1] == "scale":
                return rs.uniform(0.9, 1.1, a.shape)
            return a

        variables = jax.tree_util.tree_map_with_path(perturb, _np(variables))
        tx, _ = j_build_optimizer(_optim_cfg(), ITERS_PER_EPOCH, EPOCHS)

        def step(params, bs, opt_state, pts, gt):
            def loss_fn(p):
                def fwd_loss(mdl, pts_, gt_):
                    out = mdl(pts_, train=True)
                    loss, tb = mdl.loss(out, gt_)
                    return loss, (tb, out)

                (loss, (tb, out)), mut = model.apply(
                    {"params": p, "batch_stats": bs}, pts, gt,
                    mutable=["batch_stats", "intermediates"], method=fwd_loss,
                    capture_intermediates=lambda mdl, _m: (
                        (mdl.name or "").startswith("SA_modules")))
                return loss, (tb, out, mut)

            (loss, (tb, out, mut)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, new_opt = tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), mut["batch_stats"],
                    new_opt, loss, tb, out, mut["intermediates"], grads)

        step = jax.jit(step)
        params, bs = variables["params"], variables["batch_stats"]
        opt_state = tx.init(params)
        steps = []
        for pts, gt in batches:
            before = {"variables": {"params": _np(params), "batch_stats": _np(bs)},
                      "adam": _adam_state(opt_state)}
            params, bs, opt_state, loss, tb, out, inter, grads = step(
                params, bs, opt_state, jnp.asarray(pts, jnp.float64),
                jnp.asarray(gt, jnp.float64))
            enc_xyz = [np.asarray(t) for t in out["encoder_xyz"]]
            samp, ball = [], []
            for k in range(len(sa_cfg.NSAMPLE_LIST)):
                if sa_cfg.LAYER_TYPE[k] != "SA_Layer":
                    continue
                s = inter["backbone_3d"][f"SA_modules_{k}"]["__call__"][0][3]
                samp.append(None if s is None else np.asarray(s))
                if sa_cfg.RADIUS_LIST[k]:
                    ball.append([np.asarray(i) for i in j_ball_query_multi(
                        tuple(sa_cfg.RADIUS_LIST[k]), tuple(sa_cfg.NSAMPLE_LIST[k]),
                        jnp.asarray(enc_xyz[sa_cfg.LAYER_INPUT[k]]),
                        jnp.asarray(enc_xyz[k + 1]))])
            steps.append(dict(before, loss=float(loss), tb=_np(tb), out=_np(out),
                              samp=samp, ball=ball, batch=(pts, gt), grads=_np(grads)))
        after = {"params": _np(params), "batch_stats": _np(bs)}
    finally:
        jax.config.update("jax_enable_x64", False)
    return dict(cfg=cfg, steps=steps, after=after)


def _call_order(model, steps):
    """Each step's JAX sampling and ball-query indices, in the port's call
    order (tests/test_torch_model.py:148-164)."""
    fps_identity = [f for f, t in zip(model.backbone_3d.fps_identity,
                                      model.backbone_3d.layer_types) if t == "SA_Layer"]
    samp, ball = [], []
    for st in steps:
        samp += [s for s, f in zip(st["samp"], fps_identity) if s is not None and not f]
        ball += st["ball"]
    return samp, ball


def _fed_indices(monkeypatch, model, steps):
    """Feed each step's JAX sampling and ball-query indices to the port, in
    call order."""
    samp, ball = _call_order(model, steps)
    monkeypatch.setattr(iassd_backbone, "run_sampling",
                        lambda *a: torch.tensor(samp.pop(0)).long())
    monkeypatch.setattr(iassd_backbone, "ball_query_multi",
                        lambda r, n, xyz, c: tuple(torch.tensor(i).long() for i in ball.pop(0)))
    return samp, ball


def _port_f64(cfg, variables):
    model = build_network(cfg, NUM_CLASS, device="cpu").double()
    load_jax_variables(model, variables)
    return model


def _batch_t(pts, gt, dtype=torch.float64):
    return {"points": torch.tensor(pts, dtype=dtype), "gt_boxes": torch.tensor(gt, dtype=dtype)}


def _assert_state_close(model, cfg, want_vars, lrs):
    """Parameters within 2e-3 of the leaf scale or the Adam-crumb envelope,
    BN statistics within 1e-3 of the leaf scale (the trajectory twin's
    bounds, tests/test_train_trajectory_twin.py:665-695)."""
    want = _port_f64(cfg, want_vars).state_dict()
    crumb_env = 0.5 * sum(lrs)
    got = model.state_dict()
    worst = {"param": (0.0, ""), "stat": (0.0, "")}
    bad = []
    for key, w in want.items():
        stat = key.endswith(("running_mean", "running_var"))
        scale = max(w.abs().max().item(), 1e-3)
        err = (got[key] - w).abs().max().item()
        kind = "stat" if stat else "param"
        worst[kind] = max(worst[kind], (err / scale, key))
        if err > (1e-3 * scale if stat else max(2e-3 * scale, crumb_env)):
            bad.append((key, err, err / scale))
    assert not bad, f"state diverged: {bad[:8]}; largest relative errors {worst}"
    return worst


def test_slice_trains_like_jax_float64(jax_run, monkeypatch):
    steps, cfg = jax_run["steps"], jax_run["cfg"]
    model = _port_f64(cfg, steps[0]["variables"])
    optimizer, schedule = build_optimizer_and_schedule(
        model, _optim_cfg(), ITERS_PER_EPOCH, EPOCHS)
    train_step = make_train_step(model, optimizer, schedule)
    samp, ball = _fed_indices(monkeypatch, model, steps)
    rel = []
    for st in steps:
        loss, tb = train_step(_batch_t(*st["batch"]))
        rel.append(abs(loss.item() - st["loss"]) / abs(st["loss"]))
    assert not samp and not ball
    assert max(rel) <= 1e-6, f"per-step loss relative errors {rel}"
    worst = _assert_state_close(model, cfg, jax_run["after"],
                                [schedule.lr(t) for t in range(N_STEPS)])
    assert optimizer.count == N_STEPS, worst


def test_resume_from_jax_optimizer_state(jax_run, monkeypatch):
    steps, cfg = jax_run["steps"], jax_run["cfg"]
    last = steps[-1]
    model = _port_f64(cfg, last["variables"])
    optimizer, schedule = build_optimizer_and_schedule(
        model, _optim_cfg(), ITERS_PER_EPOCH, EPOCHS)
    load_jax_optimizer_state(optimizer, model, *last["adam"])
    assert optimizer.count == N_STEPS - 1
    samp, ball = _fed_indices(monkeypatch, model, [last])
    loss, _ = make_train_step(model, optimizer, schedule)(_batch_t(*last["batch"]))
    assert not samp and not ball
    rel = abs(loss.item() - last["loss"]) / abs(last["loss"])
    assert rel <= 1e-6, f"loss relative error {rel:.3g}"
    _assert_state_close(model, cfg, jax_run["after"], [schedule.lr(N_STEPS - 1)])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leaf_errors(got, want, floor=1e-6):
    """Per gradient leaf, max |got - want| over the leaf's scale: its
    largest |want|, floored at ``floor`` times the largest |want| of any
    leaf (below that a gradient is rounding noise: a softmax row ignores a
    shift, so the key projection's bias has a zero true gradient).  Worst
    first."""
    top = floor * max(w.abs().max().item() for w in want.values())
    return sorted((((got[n] - w).abs().max().item() / max(w.abs().max().item(), top), n)
                   for n, w in want.items()), reverse=True)


def test_two_ranks_step_like_jax_float64(jax_run, tmp_path):
    """Data parallelism against the JAX package's global batch: two Gloo
    processes (``tests/torch_dist_step.py``) take one frame each of step
    0's two-frame batch, JAX's sampling and ball-query indices of their
    frame fed.  Under GSPMD the JAX package's data-mesh step on that batch
    is its single-device step, the fixture's.  Both ranks' loss and tb
    scalars (the global batch's) within 1e-6 relative of JAX's, every
    gradient leaf (summed over the ranks) within 1e-6 of its scale, the
    BatchNorm statistics and parameters after the update within
    ``test_slice_trains_like_jax_float64``'s bounds, and the two ranks'
    state bit-equal."""
    st, cfg = jax_run["steps"][0], jax_run["cfg"]
    model = _port_f64(cfg, st["variables"])
    samp, ball = _call_order(model, [st])
    pts, gt = st["batch"]
    ranks = [dict(batch=dict(points=pts[r:r + 1], gt_boxes=gt[r:r + 1]),
                  samp=[s[r:r + 1] for s in samp],
                  ball=[[i[r:r + 1] for i in b] for b in ball]) for r in range(2)]
    spec = tmp_path / "spec.pkl"
    with open(spec, "wb") as f:
        pickle.dump(dict(cfg=cfg, num_class=NUM_CLASS, variables=st["variables"],
                         optim_cfg=_optim_cfg(), schedule=(ITERS_PER_EPOCH, EPOCHS),
                         dtype=torch.float64, ranks=ranks), f)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dist_step.py"),
                               str(spec), str(r), "2", str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for r, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        assert proc.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    got = [torch.load(f"{spec}.rank{r}.pt", weights_only=False) for r in range(2)]
    for key, val in got[0]["state"].items():
        assert torch.equal(got[1]["state"][key], val), key

    for res in got:
        assert torch.equal(res["loss"], got[0]["loss"])
        rel = abs(res["loss"].item() - st["loss"]) / abs(st["loss"])
        assert rel <= 1e-6, f"loss relative error {rel:.3g}"
        assert set(res["tb"]) == set(st["tb"])
        errs = {k: abs(float(res["tb"][k]) - float(w)) / max(abs(float(w)), 1e-6)
                for k, w in st["tb"].items()}
        assert max(errs.values()) <= 1e-6, errs
    want = dict(_port_f64(cfg, {"params": st["grads"],
                                "batch_stats": st["variables"]["batch_stats"]})
                .named_parameters())
    errs = _leaf_errors({n: g for n, g in got[0]["grads"].items()}, want)
    assert errs[0][0] <= 1e-6, f"gradients: worst {errs[:4]}"
    model.load_state_dict(got[0]["state"])
    _, schedule = build_optimizer_and_schedule(model, _optim_cfg(), ITERS_PER_EPOCH, EPOCHS)
    _assert_state_close(model, cfg, jax_run["steps"][1]["variables"], [schedule.lr(0)])


def test_one_process_runs_no_collective(monkeypatch):
    """Without a process group the data-parallel code stays out of the
    way: a train step calls no collective, the ``parallel`` helpers hand
    back their input (a share is 1.0, whose product is exact), and
    training-mode BatchNorm is the two-pass formula bit for bit."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective ran without a process group")

    for name in ("all_reduce", "broadcast", "barrier"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    assert not parallel.is_dist() and (parallel.rank(), parallel.world()) == (0, 1)
    t = torch.arange(3.0, requires_grad=True)
    assert parallel.all_reduce_sum(t) is t and parallel.all_reduce_detached(t) is t
    assert parallel.share(7, t) == 1.0

    cfg = EasyDict(tiny_model_cfg(NUM_CLASS))
    model = build_network(cfg, NUM_CLASS, device="cpu")
    optimizer, schedule = build_optimizer_and_schedule(model, _optim_cfg(), 2, 4)
    loss, tb = make_train_step(model, optimizer, schedule)(_batch_t(*_batch(5), torch.float32))
    assert torch.isfinite(loss) and "center_pos_num" in tb

    x = torch.from_numpy(np.random.RandomState(8).randn(2, 5, 7, 6).astype(np.float32))
    bn = BatchNorm(6).train()
    mean = x.mean(dim=(0, 1, 2))
    centred = x - mean
    var = (centred * centred).mean(dim=(0, 1, 2))
    assert torch.equal(bn(x), centred * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias)


def test_assign_targets_and_loss_terms_match_jax(jax_run):
    """One JAX forward dict in float32 through both target assignments and
    loss stacks."""
    cfg = jax_run["cfg"]
    st = max(jax_run["steps"], key=lambda s: float(s["tb"]["center_pos_num"]))
    head_cfg = cfg.POINT_HEAD
    gt = st["batch"][1]
    out = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), st["out"])
    j_coder = j_build_box_coder(head_cfg.TARGET_CONFIG.BOX_CODER,
                                head_cfg.TARGET_CONFIG.BOX_CODER_CONFIG)

    def j_fn(out, gt):
        targets = j_head.assign_targets(out, gt, head_cfg.TARGET_CONFIG, j_coder,
                                        NUM_CLASS)
        ret = dict(out)
        ret.update(targets)
        loss, tb = j_head.get_loss(ret, head_cfg, j_coder, NUM_CLASS, gt.shape[1])
        return targets, loss, tb

    j_targets, j_loss, j_tb = _np(jax.jit(j_fn)(out, jnp.asarray(gt)))

    t_out = jax.tree_util.tree_map(torch.from_numpy, out)
    coder = build_box_coder(head_cfg.TARGET_CONFIG.BOX_CODER,
                            head_cfg.TARGET_CONFIG.BOX_CODER_CONFIG)
    t_gt = torch.from_numpy(gt)
    targets = iassd_head.assign_targets(t_out, t_gt, head_cfg.TARGET_CONFIG, coder)
    assert set(targets) == set(j_targets)
    for key, want in j_targets.items():
        for i, (g, w) in enumerate(zip(*((targets[key], want) if isinstance(want, list)
                                         else ([targets[key]], [want])))):
            if key.endswith("box_labels"):
                np.testing.assert_allclose(g.numpy(), w, atol=1e-5, err_msg=key)
            else:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{key}[{i}]")
    assert targets["center_pos_mask"].any() and targets["center_origin_pos_mask"].any()
    ret = dict(t_out)
    ret.update(targets)
    loss, tb = iassd_head.get_loss(ret, head_cfg, coder, NUM_CLASS, gt.shape[1])
    assert set(tb) == set(j_tb)
    errs = {k: abs(float(tb[k]) - float(w)) / max(abs(float(w)), 1e-6)
            for k, w in j_tb.items()}
    assert max(errs.values()) <= 1e-5, errs
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))


def test_geometry_and_encode_match_jax():
    rs = np.random.RandomState(2)
    boxes = np.zeros((2, 4, 8), np.float32)
    boxes[..., 0:3] = rs.uniform(-5, 5, (2, 4, 3))
    boxes[..., 3:6] = rs.uniform(0.5, 4.0, (2, 4, 3))
    boxes[..., 6] = rs.uniform(-np.pi, np.pi, (2, 4))
    boxes[..., 7] = rs.randint(1, 4, (2, 4))
    boxes[:, 3] = 0.0  # a zero-padded gt row, scanned like the others
    pts = rs.uniform(-6, 6, (2, 96, 3)).astype(np.float32)
    for b in range(2):
        for m in range(3):  # points on the z faces, and 1e-5 inside the xy margin
            c, d, r = boxes[b, m, 0:3], boxes[b, m, 3:6], boxes[b, m, 6]
            for j, (lx, ly, z) in enumerate([(0.0, 0.0, d[2] / 2), (0.0, 0.0, -d[2] / 2),
                                             (d[0] / 2 + 5e-6, 0.0, 0.0),
                                             (0.0, -d[1] / 2 - 5e-6, 0.0)]):
                pts[b, 4 * m + j] = c + [lx * np.cos(r) - ly * np.sin(r),
                                         lx * np.sin(r) + ly * np.cos(r), z]
    want_mask = np.asarray(j_geometry.in_box_mask(jnp.asarray(pts), jnp.asarray(boxes[..., :7])))
    want_idx = np.asarray(j_geometry.points_in_boxes(jnp.asarray(pts),
                                                     jnp.asarray(boxes[..., :7])))
    t_pts, t_boxes = torch.from_numpy(pts), torch.from_numpy(boxes)
    np.testing.assert_array_equal(geometry.in_box_mask(t_pts, t_boxes[..., :7]).numpy(),
                                  want_mask)
    np.testing.assert_array_equal(geometry.points_in_boxes(t_pts, t_boxes[..., :7]).numpy(),
                                  want_idx)
    assert want_mask[:, :12].any(), "the face points must test the margins"

    cfg = tiny_model_cfg(NUM_CLASS).POINT_HEAD.TARGET_CONFIG
    j_coder = j_build_box_coder(cfg.BOX_CODER, cfg.BOX_CODER_CONFIG)
    coder = build_box_coder(cfg.BOX_CODER, cfg.BOX_CODER_CONFIG)
    gt_of = boxes[np.arange(2)[:, None], rs.randint(0, 4, (2, 96))]
    want = np.asarray(j_coder.encode(jnp.asarray(gt_of[..., :7]), jnp.asarray(pts),
                                     gt_classes=jnp.asarray(gt_of[..., 7])))
    got = coder.encode(torch.from_numpy(gt_of[..., :7]), t_pts,
                       gt_classes=torch.from_numpy(gt_of[..., 7]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_batchnorm_train_matches_flax():
    rs = np.random.RandomState(8)
    x = rs.randn(2, 5, 7, 6).astype(np.float32) * 2.0 + 0.5
    bn = JBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = _np(bn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = jax.tree_util.tree_map(
        lambda a: a + rs.uniform(0.1, 0.3, a.shape).astype(np.float32), variables)
    want, mut = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(6).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        port.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        port.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        port.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), atol=1e-5)


@pytest.mark.parametrize("grad_scale", [0.3, 40.0])  # global norm below / above 10
def test_optimizer_update_matches_optax(grad_scale):
    rs = np.random.RandomState(9)
    shapes = {"w": (5, 4), "b": (4,), "scale": (3,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rs.randn(*s) * grad_scale).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    tx, _ = j_build_optimizer(_optim_cfg(), ITERS_PER_EPOCH, EPOCHS)
    j_params, j_state = jax.tree_util.tree_map(jnp.asarray, params), None
    j_state = tx.init(j_params)

    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()})
    optimizer, schedule = build_optimizer_and_schedule(
        module, _optim_cfg(), ITERS_PER_EPOCH, EPOCHS)
    for t, g in enumerate(grads):  # the first two updates of the schedule
        updates, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for group in optimizer.param_groups:
            group["lr"], group["b1"] = schedule.lr(t), schedule.mom(t)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k])
        optimizer.step()
        for k, p in module.items():
            err = np.abs(p.detach().numpy() - np.asarray(j_params[k])).max()
            assert err <= 1e-6, f"update {t}, {k}: err {err:.3g}"


@pytest.mark.parametrize("grad_scale", [0.3, 40.0])  # global norm below / above 10
@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_decay_step_optimizers_match_optax_float64(name, grad_scale):
    """``adam`` and ``sgd`` against the optax chains of
    ``pdanet_tpu/train/optimization.py:99-128`` in float64: two updates an
    epoch, the learning rate decayed at epochs 1 and 2 (updates 2 and 4)
    and floored by ``LR_CLIP`` from update 4 on."""
    cfg = EasyDict(dict(OPTIMIZER=name, LR=0.01, WEIGHT_DECAY=0.01, MOMENTUM=0.9,
                        DECAY_STEP_LIST=[1, 2], LR_DECAY=0.1, LR_CLIP=5e-4,
                        GRAD_NORM_CLIP=10))
    rs = np.random.RandomState(11)
    shapes = {"w": (5, 4), "b": (4,), "scale": (3,)}
    params = {k: rs.randn(*s) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s) * grad_scale for k, s in shapes.items()} for _ in range(6)]
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()})
    optimizer, schedule = build_optimizer_and_schedule(module, cfg, 2, 3)
    jax.config.update("jax_enable_x64", True)
    try:
        tx, lr_fn = j_build_optimizer(cfg, 2, 3)
        j_params = jax.tree_util.tree_map(jnp.asarray, params)
        j_state = tx.init(j_params)
        lrs = []
        for t, g in enumerate(grads):
            updates, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), j_state,
                                         j_params)
            j_params = optax.apply_updates(j_params, updates)
            assert schedule.lr(t) == float(lr_fn(t)), t
            lrs.append(schedule.lr(t))
            for group in optimizer.param_groups:
                group["lr"] = schedule.lr(t)
                if "b1" in group:
                    group["b1"] = schedule.mom(t)
            for k, p in module.items():
                p.grad = torch.from_numpy(g[k])
            optimizer.step()
            for k, p in module.items():
                want = np.asarray(j_params[k])
                assert want.dtype == np.float64
                err = np.abs(p.detach().numpy() - want).max()
                assert err <= 1e-12, f"update {t}, {k}: err {err:.3g}"
    finally:
        jax.config.update("jax_enable_x64", False)
    assert lrs == pytest.approx([0.01, 0.01, 1e-3, 1e-3, 5e-4, 5e-4])
    assert optimizer.count == 6


def test_bf16_train_compute_tracks_f32(monkeypatch):
    """The batch of tests/test_train.py::train_setup (8 frames of 128
    points, two gt boxes), whose 8 final centres per frame hold no
    positive.  The float32 run's sampling and ball-query indices are fed to
    the bfloat16 run: at this size one flipped ctr-aware pick, or one
    centre crossing a box face, moves the loss by a third, which says
    nothing about the arithmetic."""
    cfg = EasyDict(tiny_model_cfg(NUM_CLASS))
    rs = np.random.RandomState(0)
    gt = np.zeros((8, 3, 8), np.float32)
    gt[:, 0] = [2.0, 1.0, 0.0, 3.9, 1.6, 1.56, 0.3, 1.0]
    gt[:, 1] = [-3.0, 2.0, 0.2, 0.8, 0.6, 1.73, -0.5, 2.0]
    batch = _batch_t(rs.randn(8, 128, 4) * 5, gt, torch.float32)
    weights = init_random_weights(build_network(cfg, NUM_CLASS, device="cpu"), seed=4).state_dict()
    recorded = {"run_sampling": [], "ball_query_multi": []}

    def recording(name):
        fn = getattr(iassd_backbone, name)

        def call(*args):
            recorded[name].append(fn(*args))
            return recorded[name][-1]
        return call

    traj = {}
    for name in ("f32", "bf16"):
        c = copy.deepcopy(cfg)
        for op in recorded:
            if name == "f32":
                monkeypatch.setattr(iassd_backbone, op, recording(op))
            else:
                c.BACKBONE_3D.TRAIN_COMPUTE_DTYPE = "bf16"
                monkeypatch.setattr(iassd_backbone, op,
                                    lambda *a, _q=recorded[op]: _q.pop(0))
        model = build_network(c, NUM_CLASS, device="cpu")
        model.load_state_dict(weights)
        # the schedule of tests/test_train.py::train_setup (10 x 4 updates)
        optimizer, schedule = build_optimizer_and_schedule(model, _optim_cfg(), 10, 4)
        step = make_train_step(model, optimizer, schedule)
        traj[name] = [step(batch)[0].item() for _ in range(6)]
    assert not any(recorded.values())
    rel = [abs(a - b) / abs(a) for a, b in zip(traj["f32"], traj["bf16"])]
    assert max(rel) <= 0.05, (traj, rel)
    assert traj["bf16"][-1] < traj["bf16"][0]


def test_checkpoint_round_trip_and_corruption(tmp_path):
    cfg = EasyDict(tiny_model_cfg(NUM_CLASS))
    model = build_network(cfg, NUM_CLASS, device="cpu")
    optimizer, schedule = build_optimizer_and_schedule(model, _optim_cfg(), 2, 4)
    make_train_step(model, optimizer, schedule)(_batch_t(*_batch(5), torch.float32))
    path = str(tmp_path / "checkpoint_epoch_1.pth")
    save_checkpoint(checkpoint_state(model, optimizer, epoch=1, it=1), path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint_epoch_1.pth"]
    ckpt = load_checkpoint(path)
    assert set(ckpt) == {"epoch", "it", "model_state", "optimizer_state", "version"}
    fresh = build_network(cfg, NUM_CLASS, device="cpu")
    fresh_opt, _ = build_optimizer_and_schedule(fresh, _optim_cfg(), 2, 4)
    assert restore_from_checkpoint(ckpt, fresh, fresh_opt) == (1, 1)
    for key, val in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], val), key
    assert fresh_opt.count == 1
    p0, q0 = next(model.parameters()), next(fresh.parameters())
    assert torch.equal(fresh_opt.state[q0]["nu"], optimizer.state[p0]["nu"])

    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    bad = tmp_path / "flipped.pth"
    bad.write_bytes(bytes(raw))
    with pytest.raises(CheckpointError):
        load_checkpoint(str(bad))
    (tmp_path / "cut.pth").write_bytes(bytes(raw[: len(raw) // 3]))
    with pytest.raises(CheckpointError):
        load_checkpoint(str(tmp_path / "cut.pth"))


def test_train_one_epoch_steps_once_per_batch():
    cfg = EasyDict(tiny_model_cfg(NUM_CLASS))
    model = build_network(cfg, NUM_CLASS, device="cpu")
    optimizer, schedule = build_optimizer_and_schedule(model, _optim_cfg(), 2, 4)
    loader = [dict(zip(("points", "gt_boxes"), _batch(seed)), frame_id=seed)
              for seed in (31, 32)]
    it = train_one_epoch(make_train_step(model, optimizer, schedule), loader,
                         torch.device("cpu"), accumulated_iter=3)
    assert it == 5 and optimizer.count == 2
