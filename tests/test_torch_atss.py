"""The ATSS assigner of pdanet_tpu_torch against the JAX package, on the
CPU, at the sizes of ``tests/test_atss.py``.

* ``atss_assign_targets`` on the JAX test's scene (120 random anchors,
  five gts and three padded rows a frame), on anchors in a regular grid
  with two gts that claim one anchor (the highest gt index wins), and with
  ``MATCH_HEIGHT``: labels and regression weights equal, regression
  targets within 1e-6, on JAX's anchor x gt IoU fed to the port; the
  port's own IoU within 5e-7 of it.  The two packages' float32 rotated
  overlaps differ by up to ~3e-7, and a scene's candidates can lie closer
  than that (three anchors of the third scene within 1.2e-7 of one gt's
  largest IoU), where the forced claim then picks another anchor.
* SECOND with ``TARGET_ASSIGNER_CONFIG.NAME: ATSS`` in training mode in
  float64: the loss and its terms within 1e-10 relative, every gradient
  leaf within 1e-10 of its largest |gradient|.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from pdanet_tpu.ops import rotated_iou as j_iou
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.dense_heads.atss_assigner import atss_assign_targets as j_atss
from pdanet_tpu.utils.box_coder_utils import ResidualCoder as JResidualCoder
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.dense_heads import atss_assigner
from pdanet_tpu_torch.models.dense_heads.atss_assigner import atss_assign_targets
from pdanet_tpu_torch.utils.box_coder_utils import ResidualCoder
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_second import GRID, SECOND_MODEL_CFG, _make_inputs
from test_torch_dynamic_vfe import _variables

CLASSES = ("Car", "Pedestrian")
GEOMETRY = dict(grid_size=GRID, voxel_size=(0.2, 0.2, 0.5),
                point_cloud_range=(0, -3.2, -3, 6.4, 3.2, 1), class_names=CLASSES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def random_scene(seed, B=2, A=120, M=5):
    """The JAX test's scene: anchors uniform over 20 x 20 m at two headings,
    car-sized gts of classes 1-3, three zero rows after them."""
    rng = np.random.RandomState(seed)
    anchors = np.column_stack([
        rng.uniform(0, 20, (A, 2)), np.full((A, 1), -1.0), np.tile([3.9, 1.6, 1.56], (A, 1)),
        rng.choice([0.0, 1.57], A)[:, None]]).astype(np.float32)
    gt = np.zeros((B, M + 3, 8), np.float32)
    for b in range(B):
        gt[b, :M] = np.column_stack([
            rng.uniform(2, 18, (M, 2)), rng.uniform(-1.5, -0.5, (M, 1)),
            rng.uniform(3, 5, (M, 1)), rng.uniform(1.4, 1.9, (M, 1)),
            rng.uniform(1.4, 1.7, (M, 1)), rng.uniform(-3, 3, (M, 1)),
            rng.randint(1, 4, (M, 1))])
    return anchors, gt


def grid_scene():
    """Anchors on a 1 m grid, two per location; two gts on one anchor's
    centre (both claim it: the later wins) and one off the grid."""
    xs, ys = np.meshgrid(np.arange(10.0), np.arange(8.0), indexing="ij")
    centres = np.stack([xs.ravel(), ys.ravel()], -1)
    anchors = np.concatenate([
        np.column_stack([centres, np.full((len(centres), 1), -1.0),
                         np.tile([3.9, 1.6, 1.56], (len(centres), 1)),
                         np.full((len(centres), 1), rot)]) for rot in (0.0, 1.57)])
    order = np.arange(len(anchors)).reshape(2, -1).T.ravel()  # per-location interleave
    gt = np.zeros((1, 4, 8), np.float32)
    gt[0, 0] = [4.0, 3.0, -1.0, 3.9, 1.6, 1.56, 0.0, 1]
    gt[0, 1] = [4.0, 3.0, -1.0, 3.9, 1.6, 1.56, 0.0, 2]
    gt[0, 2] = [6.37, 5.52, -0.8, 4.2, 1.8, 1.5, 0.7, 3]
    return anchors[order].astype(np.float32), gt


@pytest.mark.parametrize("scene,topk,match_height", [
    ("random0", 9, False), ("random1", 9, True), ("random2", 4, False), ("grid", 9, False)])
def test_atss_targets_equal_jax(scene, topk, match_height, monkeypatch):
    anchors, gt = grid_scene() if scene == "grid" else random_scene(int(scene[-1]))
    want = jax.jit(lambda a, g: j_atss(a, g, topk, JResidualCoder(), match_height))(anchors, gt)
    j_iou_fn = jax.jit(j_iou.boxes_iou3d if match_height else j_iou.boxes_iou_bev)
    for frame in gt:
        own = atss_assigner._anchor_gt_iou(torch.from_numpy(anchors),
                                           torch.from_numpy(frame[:, :7]), match_height)
        np.testing.assert_allclose(own.numpy(), j_iou_fn(anchors, frame[:, :7]), atol=5e-7,
                                   rtol=0)
    monkeypatch.setattr(atss_assigner, "_anchor_gt_iou", lambda a, g, _: torch.from_numpy(
        np.asarray(j_iou_fn(a.numpy(), g.numpy()))))
    got = atss_assign_targets(torch.from_numpy(anchors), torch.from_numpy(gt), topk,
                              ResidualCoder(), match_height)
    labels = got["box_cls_labels"].numpy()
    np.testing.assert_array_equal(labels, np.asarray(want["box_cls_labels"]))
    np.testing.assert_array_equal(got["reg_weights"].numpy(), np.asarray(want["reg_weights"]))
    np.testing.assert_allclose(got["box_reg_targets"].numpy(), want["box_reg_targets"],
                               atol=1e-6, rtol=0)
    assert (labels > 0).sum() >= 2
    if scene == "grid":  # gts 0 and 1 claim one anchor: gt 1 (class 2) wins
        hit = np.flatnonzero((anchors[:, 0] == 4.0) & (anchors[:, 1] == 3.0))
        assert (labels[0, hit] == 2).any() and not (labels[0] == 1).any()


def test_second_loss_with_atss_matches_jax_float64():
    cfg = copy.deepcopy(dict(SECOND_MODEL_CFG))
    cfg["DENSE_HEAD"] = dict(cfg["DENSE_HEAD"], TARGET_ASSIGNER_CONFIG={
        "NAME": "ATSS", "TOPK": 9, "MATCH_HEIGHT": False, "BOX_CODER": "ResidualCoder"})
    voxels, coords, nums = _make_inputs(B=2, seed=2)
    gt = np.zeros((2, 2, 8))
    gt[0, 0] = [3.0, 0.5, -0.8, 3.9, 1.6, 1.56, 0.3, 1]
    gt[0, 1] = [1.5, -1.0, -0.2, 0.8, 0.6, 1.73, -0.5, 2]
    gt[1, 0] = [4.5, -2.0, -0.9, 4.1, 1.7, 1.5, 1.1, 1]
    jmodel = j_build(JEasyDict(cfg), num_class=2, **GEOMETRY)
    variables = _variables(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), voxels, coords, nums)), 7, np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        def loss_fn(params):
            out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  voxels.astype(np.float64), coords, nums, train=True,
                                  mutable=["batch_stats"])
            return jmodel.apply(variables, out, gt, list(CLASSES), method=jmodel.loss)

        (loss, tb), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
        loss, tb, grads = float(loss), {k: float(v) for k, v in tb.items()}, jax.device_get(grads)
    finally:
        jax.config.update("jax_enable_x64", False)

    model = build_network(EasyDict(cfg), 2, device="cpu", **GEOMETRY).double().train()
    load_jax_variables(model, variables)
    batch = {"voxels": torch.from_numpy(voxels).double(), "voxel_coords": torch.from_numpy(coords),
             "voxel_num_points": torch.from_numpy(nums), "gt_boxes": torch.from_numpy(gt)}
    got_loss, got_tb = model.loss_batch(model.forward_batch(batch), batch)
    got_loss.backward()
    assert loss > 0 and abs(got_loss.item() - loss) <= 1e-10 * loss
    for k, w in tb.items():
        assert abs(float(got_tb[k].detach()) - w) <= 1e-10 * max(abs(w), 1e-3), k
    ref = build_network(EasyDict(cfg), 2, device="cpu", **GEOMETRY).double()
    load_jax_variables(ref, {"params": grads, "batch_stats": variables["batch_stats"]})
    want = dict(ref.named_parameters())
    worst = max((p.grad - want[n]).abs().max().item() / max(want[n].abs().max().item(), 1e-12)
                for n, p in model.named_parameters())
    assert worst <= 1e-10, worst
