"""The fixture-scale AP parity of ``tests/test_ap_parity_twin.py`` with
pdanet_tpu_torch where that file puts its PyTorch twin, on the CPU.

The JAX package and the port train side by side on the capstone fixture
with sparser pedestrians (``_sparse_ped_fixture``: ``_capstone_fixture``'s
8 frames of 2 Cars and 2 Pedestrians at random poses and graded point
budgets, the pedestrians at ``PED_POINTS``, an unlabeled car-sized
distractor a frame, clouds of exactly the 512-point budget,
``sort_points``).  On the capstone's own budgets both sides reach the
Pedestrian ceiling, where check (c) below cannot hold.  Both sides take
the same initial weights (the twin's, through the JAX converter; the port takes
them through ``load_jax_variables``) and the same batches (the port's
loader gives the JAX loader's bit for bit with augmentation off,
``tests/test_torch_learning.py``; asserted again here).  Then each trains
on its own for 800 epochs of 2 batches: the JAX side through
``_train_flax``, the port through its own ``make_train_step`` with its own
sampling, ball query, targets and ``AdamOneCycle`` (``chip_smoke.overfit``),
float32.  Each side is evaluated by its own ``eval_one_epoch`` and
official KITTI evaluation, and the pedestrian centre-match rate of each.

The assertions and constants are ``test_fixture_scale_ap_parity``'s: Car
and Pedestrian moderate 3-D AP (R40) at most 20.0 below the eval ceiling
(the gt fed back through the evaluation) on both sides, a centre-match
rate of at least 0.6, the sides within 10.0 (Car), 12.0 (Ped) and 0.4
(rate) of each other, and the weaker side below each ceiling by more than
0.5.  The canary (``test_ap_parity_mutation_canary``'s) trains the port
with the orientation-bin target shifted by one bin in
``center_box_binori_layer_loss``; its Car AP must fall below the floor.

Slow tier (``--runslow``).  ``AP_PARITY_EPOCHS`` shortens both runs for
debugging the mechanics, as in the JAX file (the AP asserts then fail).
"""

import logging
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax

import chip_smoke
import test_ap_parity_twin
from pdanet_tpu_torch.datasets import build_dataloader
from pdanet_tpu_torch.eval.eval_utils import eval_one_epoch
from pdanet_tpu_torch.models.dense_heads import iassd_head
from pdanet_tpu_torch.utils.easydict import EasyDict
from test_ap_parity_twin import (
    _CAR_FLOOR_BELOW_CEIL,
    _CAR_PARITY_TOL,
    _PED_FLOOR_BELOW_CEIL,
    _PED_PARITY_TOL,
    _PED_RATE_FLOOR,
    _PED_RATE_PARITY_TOL,
    _capstone_fixture,
    _eval_ap as _jax_eval_ap,
    _ped_center_rate as _jax_ped_center_rate,
    _train_flax,
    _twin_init,
)

CPU = torch.device("cpu")
# the pedestrians' point budgets of the fixture, in the sparser direction of
# the capstone's 70 / 45: the first of 50 / 30, 40 / 25, 30 / 20, 25 / 15
# and 20 / 12 at which the JAX side alone (800 epochs, run before and blind
# to the port) stays below both ceilings that check (c) reads
PED_POINTS = (20, 12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the tests run in
    several worker processes at once, and torch's default of a thread per
    core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _epochs():
    return int(os.environ.get("AP_PARITY_EPOCHS", "800"))


def _sparse_ped_fixture(tmp_path):
    """``_capstone_fixture`` with each frame's two pedestrians at
    ``PED_POINTS`` points, the points taken from them given to the
    background, so that every cloud stays at the 512-point budget (the
    sampler never subsamples, and train and eval clouds are the same).
    The placements, poses, cars and distractors are the capstone's (each
    frame's draws of points from its generator follow the budgets)."""
    build = test_ap_parity_twin.build_mini_kitti

    def thinned(root, n_bg, frame_objects, **kwargs):
        frames, moved = [], set()
        for objs in frame_objects:
            budgets, frame, taken = iter(PED_POINTS), [], 0
            for cls, box in objs:
                if cls == "Pedestrian":
                    n = next(budgets)
                    taken += box["npts"] - n
                    box = dict(box, npts=n)
                frame.append((cls, box))
            frames.append(frame)
            moved.add(taken)
        assert len(moved) == 1, moved  # the same budgets in every frame
        return build(root, n_bg=n_bg + moved.pop(), frame_objects=frames, **kwargs)

    with mock.patch.object(test_ap_parity_twin, "build_mini_kitti", thinned):
        return _capstone_fixture(tmp_path)


def _setup(tmp_path):
    """The sparse-pedestrian fixture and config (JAX's and the port's), and
    the initial variables as numpy."""
    jcfg, root = _sparse_ped_fixture(tmp_path)
    variables0 = _twin_init(jcfg)[2]
    return jcfg, EasyDict(jcfg), root, jax.tree_util.tree_map(np.asarray, variables0)


def _eval_ceiling(cfg, root):
    """``test_ap_parity_twin._eval_ceiling`` on the port: the ground truth
    fed back as detections through the port's prediction dicts and
    official KITTI evaluation."""
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2,
                                     training=False, root_path=root)
    annos = []
    for b in loader:
        preds = []
        for bi in range(b["batch_size"]):
            gt = np.asarray(b["gt_boxes"][bi])
            gt = gt[gt[:, 3] > 0]
            preds.append({
                "pred_boxes": gt[:, :7].astype(np.float32),
                "pred_scores": (0.9 - 0.01 * np.arange(len(gt))).astype(np.float32),
                "pred_labels": gt[:, 7].astype(np.int64),
            })
        annos += ds.generate_prediction_dicts(b, preds, cfg.CLASS_NAMES)
    return ds.evaluation(annos, cfg.CLASS_NAMES)[1]


def _eval_ap(cfg, root, model, tag, out_dir):
    """The port's ``eval_one_epoch`` with its official KITTI evaluation."""
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2,
                                    training=False, root_path=root)
    logger = logging.getLogger(f"torch_ap_parity_{tag}")
    logger.setLevel(logging.WARNING)
    return eval_one_epoch(cfg, model, loader, epoch_id=tag, logger=logger,
                          result_dir=out_dir / tag, device=CPU)


def _ped_center_rate(cfg, root, model):
    """``test_ap_parity_twin._ped_center_rate`` on the port: the share of
    gt Pedestrians whose nearest predicted centre is within 0.8 m and
    whose argmax class there is Pedestrian."""
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=4,
                                    training=False, root_path=root)
    model.eval()
    matched = total = 0
    for b in loader:
        with torch.inference_mode():
            out = model.forward_batch(
                {"points": torch.as_tensor(np.asarray(b["points"], np.float32))})
        centers = out["centers"].float().numpy()
        cls = out["batch_cls_preds"].float().numpy()
        gt = np.asarray(b["gt_boxes"])
        for bi in range(int(b["batch_size"])):
            g = gt[bi][gt[bi][:, 3] > 0]
            for p in g[g[:, 7] == 2]:
                total += 1
                d = np.linalg.norm(centers[bi] - p[None, :3], axis=-1)
                j = int(np.argmin(d))
                if d[j] < 0.8 and int(np.argmax(cls[bi, j])) == 1:
                    matched += 1
    return matched / max(total, 1), total


@pytest.mark.slow
def test_fixture_scale_ap_parity(tmp_path):
    from pdanet_tpu.datasets import build_dataloader as j_build_dataloader
    from pdanet_tpu.models import build_network as j_build_network

    jcfg, cfg, root, variables0 = _setup(tmp_path)
    epochs = _epochs()

    np.random.seed(0)
    jds, jloader, _ = j_build_dataloader(dataset_cfg=jcfg.DATA_CONFIG,
                                         class_names=jcfg.CLASS_NAMES, batch_size=4,
                                         training=True, root_path=root)
    jmodel = j_build_network(jcfg.MODEL, num_class=3, dataset=jds)
    jbatches = list(jloader)
    trained_jax = _train_flax(jcfg, jmodel, jbatches, variables0, epochs, tag="jax")

    port = chip_smoke.overfit(cfg, root, epochs, CPU, variables=variables0)
    assert len(port["batches"]) == len(jbatches) == 2
    for got, want in zip(port["batches"], jbatches):  # one frozen batch stream
        for key in got:
            np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    print("[port] " + ", ".join(f"ep {ep} loss {v:.3f}" for ep, v in port["losses"]))
    assert np.isfinite(port["loss"])

    ret_jax = _jax_eval_ap(jcfg, root, jmodel, trained_jax, "jax", tmp_path)
    ret_port = _eval_ap(cfg, root, port["model"], "port", tmp_path)
    ret_ceil = _eval_ceiling(cfg, root)
    keys = sorted(k for k in set(ret_jax) | set(ret_port)
                  if k.startswith(("Car_3d", "Car_bev", "Pedestrian_3d", "recall/")))
    print(f"\nAP parity table (sparse-pedestrian capstone fixture, 8 frames, {epochs} epochs):")
    print(f"{'metric':28s} {'pdanet_tpu':>12s} {'torch port':>12s} {'eval-max':>9s} "
          f"{'delta':>8s}")
    for k in keys:
        a, b = ret_jax.get(k, float("nan")), ret_port.get(k, float("nan"))
        c = ret_ceil.get(k, float("nan"))
        print(f"{k:28s} {a:12.2f} {b:12.2f} {c:9.2f} {a - b:8.2f}")

    car_jax, car_port = ret_jax["Car_3d/moderate_R40"], ret_port["Car_3d/moderate_R40"]
    ped_jax = ret_jax["Pedestrian_3d/moderate_R40"]
    ped_port = ret_port["Pedestrian_3d/moderate_R40"]
    car_max = ret_ceil["Car_3d/moderate_R40"]
    ped_max = ret_ceil["Pedestrian_3d/moderate_R40"]
    rate_jax, n_ped = _jax_ped_center_rate(jcfg, root, jmodel, trained_jax)
    rate_port, _ = _ped_center_rate(cfg, root, port["model"])
    print(f"ped center-match rate (of {n_ped} GT): jax {rate_jax:.2f} port {rate_port:.2f}")

    assert car_max > 0.0 and ped_max > 0.0
    # (a) quality floors on both sides, relative to the eval ceiling
    for tag, ap in (("jax", car_jax), ("port", car_port)):
        assert ap >= car_max - _CAR_FLOOR_BELOW_CEIL, (
            f"{tag} Car AP {ap:.2f} below floor {car_max - _CAR_FLOOR_BELOW_CEIL:.2f} "
            f"(ceiling {car_max:.2f})")
    for tag, ap in (("jax", ped_jax), ("port", ped_port)):
        assert ap >= ped_max - _PED_FLOOR_BELOW_CEIL, (
            f"{tag} Ped AP {ap:.2f} below floor {ped_max - _PED_FLOOR_BELOW_CEIL:.2f} "
            f"(ceiling {ped_max:.2f})")
    for tag, rate in (("jax", rate_jax), ("port", rate_port)):
        assert rate >= _PED_RATE_FLOOR, (
            f"{tag} ped center-match rate {rate:.2f} below floor {_PED_RATE_FLOOR}")
    # (b) parity between the two independent trainings
    assert abs(car_jax - car_port) <= _CAR_PARITY_TOL, (
        f"Car-moderate 3D AP diverged: jax={car_jax:.2f} port={car_port:.2f}")
    assert abs(ped_jax - ped_port) <= _PED_PARITY_TOL, (
        f"Ped-moderate 3D AP diverged: jax={ped_jax:.2f} port={ped_port:.2f}")
    assert abs(rate_jax - rate_port) <= _PED_RATE_PARITY_TOL, (
        f"ped center-match rate diverged: jax={rate_jax:.2f} port={rate_port:.2f}")
    # (c) the fixture discriminates: the weaker side below each ceiling
    car_gap = car_max - min(car_jax, car_port)
    ped_gap = ped_max - min(ped_jax, ped_port)
    assert car_gap > 0.5 and ped_gap > 0.5, (
        f"fixture saturates its eval ceilings (car gap {car_gap:.2f}, ped gap "
        f"{ped_gap:.2f}): the parity tolerances are not being exercised")


@pytest.mark.slow
def test_ap_parity_mutation_canary(tmp_path, monkeypatch):
    """The floors catch a real loss-semantics bug on the port's side: the
    orientation-bin target rotated by one bin (``center_box_labels[..., 6]``,
    the angle-bin indexing bug against IASSD_head.py:1255-1265) puts every
    decoded heading one 30-degree bin off, and the trained port's Car AP
    must land below the floor."""
    _jcfg, cfg, root, variables0 = _setup(tmp_path)
    orig = iassd_head.center_box_binori_layer_loss

    def mutated(forward_ret, loss_cfg, box_coder):
        fr = dict(forward_ret)
        lbl = fr["center_box_labels"].clone()
        lbl[..., 6] = torch.remainder(lbl[..., 6] + 1.0, float(box_coder.bin_size))
        fr["center_box_labels"] = lbl
        return orig(fr, loss_cfg, box_coder)

    monkeypatch.setattr(iassd_head, "center_box_binori_layer_loss", mutated)
    port = chip_smoke.overfit(cfg, root, _epochs(), CPU, variables=variables0)
    monkeypatch.setattr(iassd_head, "center_box_binori_layer_loss", orig)

    car_mut = _eval_ap(cfg, root, port["model"], "mut", tmp_path)["Car_3d/moderate_R40"]
    car_max = _eval_ceiling(cfg, root)["Car_3d/moderate_R40"]
    print(f"[canary] mutated Car AP {car_mut:.2f} vs ceiling {car_max:.2f} "
          f"(floor {car_max - _CAR_FLOOR_BELOW_CEIL:.2f})")
    assert car_mut < car_max - _CAR_FLOOR_BELOW_CEIL, (
        f"mutation canary did NOT trip: mutated Car AP {car_mut:.2f} >= floor "
        f"{car_max - _CAR_FLOOR_BELOW_CEIL:.2f}")
