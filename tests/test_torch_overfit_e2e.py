"""The learning checks of ``tests/test_overfit_e2e.py`` on pdanet_tpu_torch,
on the CPU: each of the four detectors (point-based PDA-SSD, anchor
PointPillar, heatmap CenterPoint, two-stage Voxel-RCNN) overfits the
compact 4-frame mini-KITTI fixture and must then DETECT the car in every
frame through post-processing.

Each test takes the JAX test's config, epochs, learning rate and asserts
unchanged, and starts where the JAX test starts: JAX's ``model.init`` at
``PRNGKey(0)``, carried into the port by ``load_jax_variables``.  From
there the port trains on its own: its loader (the port's
``create_kitti_infos`` over the same fixture, batch 4), its
``make_train_step`` (its own sampling, targets, RoI draws from the
per-frame generators, ``AdamOneCycle``), float32.  The training loop and
the detection rule are ``chip_smoke.overfit`` and
``chip_smoke.detect_cars``, which phase 24 of ``chip_smoke.py`` runs on the
card from the port's own seeded weights: a car counts as found at a score
above 0.3, label 1 and a 3-D IoU of at least 0.3 with the frame's car, on
the test split as the JAX test reads it (``chip_smoke.test_split``), after
every car of the clouds the model trained on (``chip_smoke.trained_on``).

PDA-SSD's test split is another draw of 512 of each frame's 1150 points
than the one trained on in both packages: the JAX package's loader draws
from numpy's global generator, the port's from per-sample generators
seeded from (loader seed, epoch, index), and ``chip_smoke.test_split``
reads it at the training seed plus one (``TEST_SPLIT_SEED``).  Whether
every car is found depends on the draw in both packages; the JAX test
itself fails on some runs (ROADMAP item 6 and queue 3).  So the PDA-SSD
test also hands the port's trained weights to the JAX package
(``port_variables``) and evaluates the same clouds there by the same
rule: the frames with a car must be the same in both packages, on the
clouds trained on and on the test split, and each frame's confident car
detections must be as many in both and pair box to box (3-D IoU of at
least 0.5, each the other's best).  That
separates a miss of the port's from a miss of the trained weights.

Slow tier (``--runslow``): 150-300 epochs each.
"""

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from kitti_fixture import build_mini_kitti
from pdanet_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
from test_cli import CP_TINY_CFG, PP_TINY_CFG, TINY_CFG, VR_TINY_CFG

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the tests run in
    several worker processes at once, and torch's default of a thread per
    core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _fixture(tmp_path, label, cfg_text):
    """``test_overfit_e2e._build_fixture`` with the port's infos: the
    compact fixture, the world augmentations off, PDA-SSD's overrides."""
    root = tmp_path / "kitti"
    build_mini_kitti(root, **chip_smoke.LEARNING_FIXTURE)
    cfg = chip_smoke.learning_cfg(label, cfg_text, root)
    create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root, workers=1)
    return root, cfg


def _jax_init(cfg, root):
    """The JAX test's initial variables: ``model.init`` at ``PRNGKey(0)`` on
    the first batch of its loader (``test_overfit_e2e.py:64-77``), as numpy."""
    from pdanet_tpu.datasets import build_dataloader
    from pdanet_tpu.models import build_network
    from pdanet_tpu.train.train_utils import select_device_batch
    from pdanet_tpu.utils.easydict import EasyDict as JEasyDict

    jcfg = JEasyDict(cfg)
    np.random.seed(0)
    ds, loader, _ = build_dataloader(
        dataset_cfg=jcfg.DATA_CONFIG, class_names=jcfg.CLASS_NAMES,
        batch_size=4, training=True, root_path=root)
    model = build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES), dataset=ds)
    example = select_device_batch(next(iter(loader)), model)
    variables = jax.jit(lambda r, b: model.init(
        {"params": r}, b, train=False, method=model.forward_batch))(
        jax.random.PRNGKey(0), example)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _jax_frames(cfg, model, batches):
    """The port's trained ``model`` in the JAX package (``port_variables``):
    each frame of ``batches`` through its forward and post-processing,
    judged by ``test_overfit_e2e._detect_cars``'s rule; per frame (car
    found, the confident label-1 boxes (k, 7))."""
    import jax.numpy as jnp

    from pdanet_tpu.models import build_network as j_build_network
    from pdanet_tpu.models.detectors import get_post_processor as j_get_post_processor
    from pdanet_tpu.ops.rotated_iou import boxes_iou3d as j_boxes_iou3d
    from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
    from pdanet_tpu_torch.utils.jax_weights import port_variables

    jcfg = JEasyDict(cfg)
    jmodel = j_build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES), input_channels=4)
    post_fn = j_get_post_processor(jcfg.MODEL.NAME)
    variables = port_variables(model)

    @jax.jit
    def forward(variables, points):
        out = jmodel.apply(variables, {"points": points}, train=False,
                           method=jmodel.forward_batch)
        return post_fn(out, jcfg.MODEL)

    frames = []
    for batch, gt in batches:
        pred = jax.tree_util.tree_map(np.asarray,
                                      forward(variables, jnp.asarray(batch["points"].numpy())))
        gt = np.asarray(gt)
        for bi in range(gt.shape[0]):
            n = int(pred["pred_counts"][bi])
            boxes = pred["pred_boxes"][bi][:n, :7]
            confident = ((pred["pred_scores"][bi][:n] > chip_smoke.LEARNING_SCORE)
                         & (pred["pred_labels"][bi][:n] == 1))
            g = gt[bi][gt[bi][:, 3] > 0]
            cars = g[g[:, 7] == 1.0]
            found = n > 0 and len(cars) > 0 and bool(
                ((np.asarray(j_boxes_iou3d(jnp.asarray(boxes), jnp.asarray(cars[:, :7])))
                  * confident[:, None]).max(axis=0) >= chip_smoke.LEARNING_IOU).any())
            frames.append((found, boxes[confident]))
    return frames


def _matched(port_boxes, jax_boxes, thresh=0.5):
    """Confident car detections of one frame paired across the packages by
    box: the pairs whose 3-D IoU is at least ``thresh`` and each one's best."""
    from pdanet_tpu_torch.ops.rotated_iou import boxes_iou3d

    if len(port_boxes) == 0 or len(jax_boxes) == 0:
        return 0
    iou = boxes_iou3d(torch.as_tensor(port_boxes), torch.as_tensor(jax_boxes)).numpy()
    best_p, best_j = iou.argmax(axis=1), iou.argmax(axis=0)
    return int(sum(iou[i, best_p[i]] >= thresh and best_j[best_p[i]] == i
                   for i in range(len(port_boxes))))


def _same_weights(cfg, run, splits):
    """Per split (name, batches): the frames with a car in the port and in
    the JAX package on the port's trained weights, and per frame the
    confident car detections of each and how many pair by box."""
    rows = {}
    for name, batches in splits:
        port = chip_smoke.detect_frames(cfg, run["model"], batches)
        jax_side = _jax_frames(cfg, run["model"], batches)
        rows[name] = [dict(port=p[0], jax=j[0], n_port=len(p[1]), n_jax=len(j[1]),
                           paired=_matched(p[1], j[1])) for p, j in zip(port, jax_side)]
        print(f"same weights, {name}: " + "; ".join(
            f"frame {i}: car port {r['port']} / JAX {r['jax']}, confident cars "
            f"{r['n_port']} / {r['n_jax']}, paired by box {r['paired']}"
            for i, r in enumerate(rows[name])))
    return rows


def _overfit_and_detect(tmp_path, label, cfg_text, epochs, same_weights=False):
    root, cfg = _fixture(tmp_path, label, cfg_text)
    run = chip_smoke.overfit(cfg, root, epochs, CPU, variables=_jax_init(cfg, root))
    print(f"{label}: " + ", ".join(f"ep {ep} loss {v:.3f}" for ep, v in run["losses"]))
    assert np.isfinite(run["loss"])
    split = chip_smoke.test_split(cfg, root, CPU, run["model"])
    own = chip_smoke.detect_cars(cfg, run["model"], chip_smoke.trained_on(run))
    car_frames, total, nonfinite = chip_smoke.detect_cars(cfg, run["model"], split)
    print(f"{label}: car found in {own[0]}/{own[1]} frames trained on, {car_frames}/{total} "
          f"of the test split, {own[2] + nonfinite} non-finite boxes")
    if same_weights:
        rows = _same_weights(cfg, run, (("trained on", chip_smoke.trained_on(run)),
                                        ("test split", split)))
        for name, frames in rows.items():
            assert [r["port"] for r in frames] == [r["jax"] for r in frames], (
                f"{name}: the frames with a car differ between the port and the JAX package "
                f"on the same weights: {frames}")
            # and each frame's confident cars are the same boxes in both
            assert all(r["n_port"] == r["n_jax"] == r["paired"] for r in frames), (
                f"{name}: the confident cars differ between the port and the JAX package on "
                f"the same weights: {frames}")
    assert own[0] == own[1] == 4, f"car found in {own[0]}/4 frames trained on"
    return run, car_frames, total


@pytest.mark.slow
def test_pda_ssd_overfit_produces_detections(tmp_path):
    run, car_frames, total = _overfit_and_detect(tmp_path, "PDA-SSD", TINY_CFG, 250,
                                                 same_weights=True)
    assert run["tb"]["center_pos_num"] > 0, run["tb"]
    assert total == 4
    assert car_frames == 4, f"car found in {car_frames}/4 frames"


@pytest.mark.slow
def test_pointpillar_overfit_produces_detections(tmp_path):
    _, car_frames, total = _overfit_and_detect(tmp_path, "PointPillar", PP_TINY_CFG, 300)
    assert total == 4
    assert car_frames == 4, f"car found in {car_frames}/4 frames"


@pytest.mark.slow
def test_centerpoint_overfit_produces_detections(tmp_path):
    """BN_MOMENTUM 0.9 (the tiny config's, on the 3-D and BEV backbones) lets
    the eval statistics converge at fixture step counts
    (``test_overfit_e2e.py:182-190``)."""
    _, car_frames, total = _overfit_and_detect(tmp_path, "CenterPoint", CP_TINY_CFG, 150)
    assert total == 4
    assert car_frames == 4, f"car found in {car_frames}/4 frames"


@pytest.mark.slow
def test_voxel_rcnn_overfit_produces_detections(tmp_path):
    """Two stages: the RPN learns proposals and the RoI head the IoU-quality
    scores and refinements that clear the 0.3 score gate; the RoI sampler
    draws from the train step's per-frame generators."""
    _, car_frames, total = _overfit_and_detect(tmp_path, "Voxel-RCNN", VR_TINY_CFG, 300)
    assert total == 4
    assert car_frames == 4, f"car found in {car_frames}/4 frames"
