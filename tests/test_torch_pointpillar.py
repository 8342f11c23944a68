"""The PointPillar slice of pdanet_tpu_torch against the JAX package, on
the CPU, at the tiny config of ``tests/test_pointpillar.py`` (a 64 x 64
grid of 0.4 m pillars, 16 / 32 filters, 512 pillars of 8 points,
``NMS_PRE_MAXSIZE`` 256), inputs from a numpy seed, weights carried from
the flax variables by the weight bridge.

* The voxelizer and the voxel collate equal to the JAX package's, each on
  its own g++ host library, over-cap voxels and points included.
* ``PillarVFE`` and the scatter in training mode within 1e-5 of the map's
  largest |value| (float32),
  with non-full pillars (whose max sees the padded rows' phantom vector)
  and padded slots; the BatchNorm running statistics within 1e-6.
* ``BaseBEVBackbone`` with ``UPSAMPLE_STRIDES`` 1, 2 and 4 (transposed
  convolutions, whose kernels the bridge flips) and with the stride-0.5
  conv and ``deblocks_final`` branch, within 1e-5.
* Anchors and labels equal, regression targets within 1e-6, on frames
  with no gt, a force-matched gt and padded gt rows.
* The whole tiny model in training mode in float64: the loss and every
  leaf of its gradient within 1e-10 of ``jax.grad``'s (relative to the
  leaf's largest |gradient|), the BatchNorm running statistics too.
* At eval in float32: logits within 1e-4 and boxes within 1e-4, and the
  detections of ``post_processing`` paired box for box with JAX's (the
  score margin printed); the exported program (``serving.export_serving``)
  equal to the eager closure, and refused by the serve CLI.
* ``build_network`` on the shipped ``pointpillar.yaml`` through the
  dataset's geometry, filled by a JAX tree of the same config (every
  leaf consumed); the other detectors of the zoo raise.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate
from pdanet_tpu.datasets.processor.data_processor import DataProcessor as JDataProcessor
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.backbones_2d.base_bev_backbone import BaseBEVBackbone as JBEV
from pdanet_tpu.models.dense_heads import anchor_head as JAH
from pdanet_tpu.models.detectors.iassd import post_processing as j_post
from pdanet_tpu.utils.box_coder_utils import ResidualCoder as JResidualCoder
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.datasets.processor.data_processor import DataProcessor
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_2d.base_bev_backbone import BaseBEVBackbone
from pdanet_tpu_torch.models.dense_heads import anchor_head as AH
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.utils.box_coder_utils import ResidualCoder
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_pointpillar import GRID, PCR, PP_MODEL_CFG, VOXEL

REPO = Path(__file__).resolve().parent.parent
PP_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "pointpillar.yaml"
CLASSES = ("Car", "Pedestrian")
B, V, P = 2, 512, 8
GEOMETRY = dict(grid_size=GRID, voxel_size=tuple(VOXEL), point_cloud_range=tuple(PCR))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _vox_cfg(max_pts=P, max_voxels=V):
    return {"NAME": "transform_points_to_voxels", "VOXEL_SIZE": VOXEL,
            "MAX_POINTS_PER_VOXEL": max_pts,
            "MAX_NUMBER_OF_VOXELS": {"train": max_voxels, "test": max_voxels}}


def _cloud(rs, n=800):
    xyz = rs.uniform([0, -12.8, -3], [25.6, 12.8, 1], (n, 3))
    # a few dense clusters fill pillars past their cap
    for c in rs.uniform([2, -10, -2], [23, 10, 0], (6, 3)):
        xyz = np.concatenate([xyz, c + rs.uniform(-0.15, 0.15, (40, 3))])
    xyz = np.concatenate([xyz, rs.uniform([-5, -20, -4], [30, 20, 2], (60, 3))])  # some outside
    return np.concatenate([xyz, rs.uniform(0, 1, (len(xyz), 1))], axis=1).astype(np.float32)


def _voxelize_both(points, training, max_pts=P, max_voxels=V):
    outs = []
    for cls, ed in ((DataProcessor, EasyDict), (JDataProcessor, JEasyDict)):
        dp = cls([ed(_vox_cfg(max_pts, max_voxels))], point_cloud_range=np.asarray(PCR),
                 training=training, num_point_features=4)
        outs.append(dp.forward({"points": points.copy()}))
    return outs


def _frames(seed=0):
    """B voxelized frames (the port's voxelizer), collated."""
    rs = np.random.RandomState(seed)
    frames = []
    for _ in range(B):
        dd, _ = _voxelize_both(_cloud(rs, 300), training=False)
        frames.append(dd)
    return DatasetTemplate.collate_batch_static(frames)


@pytest.mark.parametrize("training,max_pts,max_voxels", [(False, P, V), (True, 4, 96)])
def test_voxelizer_equals_jax(training, max_pts, max_voxels):
    """Equal arrays, in first-appearance voxel order and scan order within
    a voxel, at the test budget and at a cap that drops voxels and points."""
    points = _cloud(np.random.RandomState(11))
    got, want = _voxelize_both(points, training, max_pts, max_voxels)
    assert set(got) == set(want)
    for key in ("voxels", "voxel_coords", "voxel_num_points"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["max_number_of_voxels"] == want["max_number_of_voxels"] == max_voxels
    counts = got["voxel_num_points"]
    assert counts.max() == max_pts and counts.min() == 1  # full and non-full pillars
    assert len(counts) == max_voxels or max_voxels == V


def test_dataset_grid_and_collate_equal_jax():
    """The dataset's grid size and voxel size, and the collate of frames
    with different voxel and point counts (the voxel triplet padded to the
    cap, coords with -1; ragged points zero-padded with ``num_points``)."""
    cfg = cfg_from_yaml_file(str(PP_YAML))
    for cls in (DatasetTemplate, JDatasetTemplate):
        ds = cls(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, training=False,
                 root_path=".")
        np.testing.assert_array_equal(ds.grid_size, [432, 496, 1])
        assert list(ds.voxel_size) == [0.16, 0.16, 4]
    rs = np.random.RandomState(5)
    frames = [[], []]
    for n in (300, 700):
        pts = _cloud(rs, n)
        gt = rs.rand(int(n / 100), 8).astype(np.float32)
        for side, dd in zip(frames, _voxelize_both(pts, training=True)):
            dd["gt_boxes"] = gt
            side.append(dd)
    got = DatasetTemplate.collate_batch_static(frames[0], max_gt_cap=12)
    want = JDatasetTemplate.collate_batch_static(frames[1], max_gt_cap=12)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["voxel_coords"].shape == (2, V, 3) and (got["voxel_coords"] == -1).any()
    assert list(got["num_points"]) == [len(f["points"]) for f in frames[0]]


def _perturb(variables, seed, dtype=np.float32):
    """The flax tree as numpy, BatchNorm statistics and affine parameters
    and the biases drawn, so that nothing is the identity."""
    rs = np.random.RandomState(seed)

    def one(path, a):
        leaf = path[-1].key
        if leaf == "var":
            a = rs.uniform(0.5, 2.0, a.shape)
        elif leaf in ("mean", "bias"):
            a = rs.uniform(-0.2, 0.2, a.shape)
        elif leaf == "scale":
            a = rs.uniform(0.8, 1.2, a.shape)
        return np.asarray(a, dtype)

    return jax.tree_util.tree_map_with_path(one, jax.device_get(variables))


def _stats_close(model, want_stats, atol):
    """The port's BatchNorm running statistics against a flax
    ``batch_stats`` tree."""
    got = dict(model.named_buffers())
    flat = _flat(jax.device_get(want_stats))
    assert flat
    for key, v in flat.items():
        *mods, leaf = key.split("/")
        name = ".".join(mods + [{"mean": "running_mean", "var": "running_var"}[leaf]])
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(v), atol=atol,
                                   rtol=0, err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def pp_run():
    """The tiny JAX model at eval in float32 on two voxelized frames, with
    perturbed weights, and a port model holding the same weights."""
    cfg = EasyDict(PP_MODEL_CFG)
    jmodel = j_build(JEasyDict(PP_MODEL_CFG), num_class=len(CLASSES), input_channels=4,
                     class_names=CLASSES, **GEOMETRY)
    batch = _frames()
    args = [jnp.asarray(batch[k]) for k in ("voxels", "voxel_coords", "voxel_num_points")]
    variables = jax.jit(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a, train=False))(*args)
    variables = _perturb(variables, 3)
    out = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(variables, *args)
    post = jax.jit(lambda c, b: j_post(c, b, cfg.POST_PROCESSING))(
        out["batch_cls_preds"], out["batch_box_preds"])
    model = build_network(cfg, len(CLASSES), class_names=CLASSES, device="cpu",
                          **GEOMETRY).eval()
    load_jax_variables(model, variables)
    return dict(cfg=cfg, jmodel=jmodel, batch=batch, variables=variables,
                out=jax.device_get(out), post=jax.device_get(post), model=model)


def _device_batch(batch, dtype=torch.float32):
    return {"voxels": torch.from_numpy(batch["voxels"]).to(dtype),
            "voxel_coords": torch.from_numpy(batch["voxel_coords"]),
            "voxel_num_points": torch.from_numpy(batch["voxel_num_points"])}


def test_pillar_vfe_and_scatter_match_jax(pp_run):
    """Training mode (batch statistics over every pillar slot, padded ones
    included, as in JAX), float32: the scattered BEV map within 1e-5 of its
    largest |value| (float32 rounds its raw coordinates, up to 25.6 m, at
    1e-6 already), the VFE's running statistics within 1e-6."""
    from pdanet_tpu.models.backbones_2d.map_to_bev.pointpillar_scatter import (
        pointpillar_scatter as j_scatter)
    from pdanet_tpu.models.backbones_3d.vfe.pillar_vfe import PillarVFE as JPillarVFE
    from pdanet_tpu_torch.models.backbones_2d.map_to_bev.pointpillar_scatter import (
        pointpillar_scatter)

    batch, variables = pp_run["batch"], pp_run["variables"]
    n = batch["voxel_num_points"]
    assert (n == P).any() and ((n > 0) & (n < P)).any() and (n == 0).any()
    jvfe = JPillarVFE(model_cfg=JEasyDict(PP_MODEL_CFG["VFE"]), num_point_features=4,
                      voxel_size=VOXEL, point_cloud_range=PCR)
    vfe_vars = {"params": variables["params"]["vfe"],
                "batch_stats": variables["batch_stats"]["vfe"]}
    args = [jnp.asarray(batch[k]) for k in ("voxels", "voxel_coords", "voxel_num_points")]
    feats, mut = jax.jit(lambda v, *a: jvfe.apply(v, *a, train=True, mutable=["batch_stats"]))(
        vfe_vars, *args)
    want = np.asarray(jax.jit(lambda f, c: j_scatter(f, c, GRID, 16))(feats, args[1]))

    model = build_network(pp_run["cfg"], len(CLASSES), class_names=CLASSES, device="cpu",
                          **GEOMETRY)
    load_jax_variables(model, variables)
    model.vfe.train()
    dev = _device_batch(batch)
    got = pointpillar_scatter(model.vfe(*dev.values()), dev["voxel_coords"], GRID)
    assert got.shape == (B, 64, 64, 16)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5 * scale, rtol=0)
    _stats_close(model.vfe, mut["batch_stats"], atol=1e-6)


BEV_CASES = {
    "upsample_1_2_4": {"LAYER_NUMS": [1, 1, 1], "LAYER_STRIDES": [2, 2, 2],
                       "NUM_FILTERS": [8, 16, 16], "UPSAMPLE_STRIDES": [1, 2, 4],
                       "NUM_UPSAMPLE_FILTERS": [8, 8, 8]},
    "conv_half_and_final": {"LAYER_NUMS": [1, 1], "LAYER_STRIDES": [1, 2],
                            "NUM_FILTERS": [8, 16], "UPSAMPLE_STRIDES": [0.5, 1, 2],
                            "NUM_UPSAMPLE_FILTERS": [8, 8]},
}


@pytest.mark.parametrize("case", sorted(BEV_CASES))
def test_bev_backbone_matches_jax(case):
    """The BEV backbone through the weight bridge, at eval and in training
    mode, within 1e-5: a transposed conv's kernel without the bridge's
    spatial flip is off by O(1)."""
    cfg = BEV_CASES[case]
    x = np.random.RandomState(7).randn(2, 32, 24, 6).astype(np.float32)
    jmod = JBEV(model_cfg=JEasyDict(cfg), input_channels=6)
    # every leaf drawn (kernels asymmetric under the flip) into the tree's
    # shapes, which need no compile
    rs = np.random.RandomState(9)
    draw = {"kernel": lambda shp: rs.randn(*shp) / np.sqrt(np.prod(shp[:-1])),
            "var": lambda shp: rs.uniform(0.5, 2.0, shp),
            "scale": lambda shp: rs.uniform(0.8, 1.2, shp)}
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: draw.get(p[-1].key, lambda shp: rs.uniform(-0.2, 0.2, shp))(
            a.shape).astype(np.float32),
        jax.eval_shape(jmod.init, jax.random.PRNGKey(1), jnp.asarray(x)))
    want = jax.jit(lambda v, a: (
        jmod.apply(v, a, train=False),
        jmod.apply(v, a, train=True, mutable=["batch_stats"])[0]))(variables, jnp.asarray(x))
    port = BaseBEVBackbone(EasyDict(cfg), 6)
    load_jax_variables(port, variables)
    for train, w in zip((False, True), want):
        port.train(train)
        got = port(torch.from_numpy(x)).detach().numpy()
        assert got.shape == w.shape
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-5, rtol=0,
                                   err_msg=f"train={train}")
    # the widest transposed conv's kernel, unflipped: off by O(1)
    name = max((k for k in variables["params"] if k.endswith("deconv")),
               key=lambda k: variables["params"][k]["kernel"].shape[0])
    wrong = np.asarray(variables["params"][name]["kernel"]).transpose(2, 3, 0, 1)
    load_jax_variables(port, variables)  # the statistics before the train pass
    with torch.no_grad():
        getattr(port, name).weight.copy_(torch.from_numpy(np.ascontiguousarray(wrong)))
    port.eval()
    assert np.abs(port(torch.from_numpy(x)).detach().numpy() - np.asarray(want[0])).max() > 1e-2


def _gt_frames():
    """Three frames of gt (M = 4, zero-padded): no gt at all; a Car on an
    anchor and a Pedestrian between anchors, whose best IoU is under the
    matched threshold (force-matched); a rotated Car, a Car past the map's
    edge (best IoU 0, never forced) and padded rows."""
    gt = np.zeros((3, 4, 8), np.float32)
    gt[1, 0] = [12.8, 0.0, -1.0, 3.9, 1.6, 1.56, 0.0, 1]
    gt[1, 1] = [6.1, 3.1, -0.6, 0.5, 0.4, 1.73, 0.3, 2]
    gt[2, 0] = [8.0, -4.0, -1.0, 4.2, 1.7, 1.5, 1.2, 1]
    gt[2, 1] = [60.0, 40.0, -1.0, 3.9, 1.6, 1.5, 0.0, 1]
    return gt


def test_anchors_and_targets_match_jax():
    """Anchors equal; labels equal; regression targets within 1e-6; a force
    match and an empty gt row hold as in JAX."""
    gen = PP_MODEL_CFG["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]
    anchors, per_loc = AH.generate_anchors(gen, GRID, PCR)
    j_anchors, j_per_loc = JAH.generate_anchors(gen, GRID, PCR)
    assert per_loc == j_per_loc == [2, 2]
    for a, w in zip(anchors, j_anchors):
        np.testing.assert_array_equal(a, w)
    flat, per_class = AH.flat_anchors_per_class(anchors)
    j_flat, j_per_class = JAH.flat_anchors_per_class(j_anchors)
    np.testing.assert_array_equal(flat, j_flat)
    gt = _gt_frames()
    args = dict(class_ids=[1, 2], thresholds=[(0.6, 0.45), (0.5, 0.35)])
    got = AH.assign_targets([torch.from_numpy(a) for a in per_class], torch.from_numpy(gt),
                            box_coder=ResidualCoder(), **args)
    want = jax.device_get(jax.jit(lambda pc, g: JAH.assign_targets(
        pc, g, box_coder=JResidualCoder(), **args))(
            [jnp.asarray(a) for a in j_per_class], jnp.asarray(gt)))
    np.testing.assert_array_equal(got["box_cls_labels"].numpy(), want["box_cls_labels"])
    np.testing.assert_allclose(got["box_reg_targets"].numpy(), want["box_reg_targets"],
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["reg_weights"].numpy(), want["reg_weights"])
    labels = got["box_cls_labels"].numpy()
    assert (labels[0] == 0).all()  # no gt: all background
    assert (labels[1] == 1).any() and (labels[1] == 2).sum() >= 1  # the forced Pedestrian
    ped_iou = AH.nearest_bev_iou(torch.from_numpy(per_class[1].reshape(-1, 7)),
                                 torch.from_numpy(gt[1, 1:2, :7]))
    assert ped_iou.max() < 0.5  # below its matched threshold: a force match
    assert (labels[2] == 1).any() and (labels[2] == -1).any()


@pytest.fixture(scope="module")
def pp_f64(pp_run):
    """One JAX train-mode forward, loss and gradient of the tiny model in
    float64 on two frames with gt (one with padded gt rows)."""
    jax.config.update("jax_enable_x64", True)
    try:
        jmodel = pp_run["jmodel"]
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                           pp_run["variables"])
        batch = pp_run["batch"]
        args = [jnp.asarray(batch["voxels"], jnp.float64), jnp.asarray(batch["voxel_coords"]),
                jnp.asarray(batch["voxel_num_points"])]
        gt = _gt_frames()[1:]

        def loss_fn(params, gt_):
            out, mut = jmodel.apply({"params": params,
                                     "batch_stats": variables["batch_stats"]},
                                    *args, train=True, mutable=["batch_stats"])
            loss, tb = jmodel.apply(variables, out, gt_, list(CLASSES), method=jmodel.loss)
            return loss, (tb, mut["batch_stats"])

        (loss, (tb, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], jnp.asarray(gt, jnp.float64))
        return dict(variables=variables, gt=gt, loss=float(loss),
                    tb={k: float(v) for k, v in tb.items()},
                    grads=jax.device_get(grads), stats=jax.device_get(stats))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_loss_and_gradients_match_jax_float64(pp_run, pp_f64):
    """The anchor-head loss and its tb terms within 1e-10 relative, every
    gradient leaf within 1e-10 of its largest |gradient|, and the running
    statistics the train forward leaves within 1e-12."""
    cfg = pp_run["cfg"]
    model = build_network(cfg, len(CLASSES), class_names=CLASSES, device="cpu",
                          **GEOMETRY).double()
    load_jax_variables(model, pp_f64["variables"])
    model.train()
    batch = _device_batch(pp_run["batch"], torch.float64)
    batch["gt_boxes"] = torch.from_numpy(pp_f64["gt"]).double()
    loss, tb = model.loss_batch(model.forward_batch(batch), batch)
    loss.backward()
    assert abs(loss.item() - pp_f64["loss"]) <= 1e-10 * abs(pp_f64["loss"])
    assert set(tb) == set(pp_f64["tb"])
    for k, w in pp_f64["tb"].items():
        assert abs(float(tb[k]) - w) <= 1e-10 * max(abs(w), 1e-3), k
    ref = build_network(cfg, len(CLASSES), class_names=CLASSES, device="cpu",
                        **GEOMETRY).double()
    load_jax_variables(ref, {"params": pp_f64["grads"],
                             "batch_stats": pp_f64["variables"]["batch_stats"]})
    want = dict(ref.named_parameters())
    worst = []
    for name, p in model.named_parameters():
        scale = want[name].abs().max().item()
        assert scale > 0, f"{name}: no gradient in JAX"
        worst.append(((p.grad - want[name]).abs().max().item() / scale, name))
    worst.sort(reverse=True)
    assert worst[0][0] <= 1e-10, f"gradients, worst first: {worst[:4]}"
    _stats_close(model, pp_f64["stats"], atol=1e-12)


def _match(got, want):
    """Detections paired box for box: per frame equal counts and labels,
    each JAX box's nearest port box of its label within 1e-3 m, scores
    within 1e-4.  Returns the largest box and score differences."""
    box_err = score_err = 0.0
    for b in range(len(want["pred_counts"])):
        n = int(want["pred_counts"][b])
        assert int(got["pred_counts"][b]) == n, f"frame {b}: counts"
        gb, wb = got["pred_boxes"][b][:n], want["pred_boxes"][b][:n]
        for i in range(n):
            same = got["pred_labels"][b][:n] == want["pred_labels"][b][i]
            d = np.where(same, np.linalg.norm(gb[:, :3] - wb[i, :3], axis=1), np.inf)
            j = int(np.argmin(d))
            box_err = max(box_err, np.abs(gb[j] - wb[i]).max())
            score_err = max(score_err, abs(got["pred_scores"][b][j] - want["pred_scores"][b][i]))
    return box_err, score_err


def test_model_eval_matches_jax(pp_run):
    """Eval in float32: logits and decoded boxes within 1e-4, and the
    detections paired box for box with the JAX package's."""
    model, j = pp_run["model"], pp_run["out"]
    with torch.no_grad():
        out = model.forward_batch(_device_batch(pp_run["batch"]))
        post = get_post_processor("PointPillar")(out, pp_run["cfg"])
    A = 32 * 32 * 4
    assert out["batch_cls_preds"].shape == (B, A, 2)
    for key in ("cls_preds", "box_preds", "dir_cls_preds"):
        np.testing.assert_allclose(out[key].numpy(), j[key], atol=1e-4, rtol=0, err_msg=key)
    np.testing.assert_allclose(out["batch_box_preds"].numpy(), j["batch_box_preds"],
                               atol=1e-4, rtol=0)
    post = {k: v.numpy() for k, v in post.items()}
    assert post["pred_counts"].min() > 0
    box_err, score_err = _match(post, pp_run["post"])
    print(f"detections paired: max box diff {box_err:.3g} m, max score diff {score_err:.3g}")
    assert box_err <= 1e-3 and score_err <= 1e-4


def test_exported_program_equals_eager(pp_run, tmp_path):
    """The voxel program traced by ``torch.export``, saved and reloaded,
    gives the eager closure's outputs exactly; the serve CLI, which reads
    point clouds, refuses it."""
    model, cfg = pp_run["model"], pp_run["cfg"]
    batch = _device_batch(pp_run["batch"])
    exported = serving.export_serving(model, cfg, batch)
    path = tmp_path / "pp_b2.pt2"
    full = EasyDict(MODEL=cfg, CLASS_NAMES=list(CLASSES), DATA_CONFIG=EasyDict(
        DATA_PROCESSOR=[EasyDict(_vox_cfg())],
        POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z", "intensity"]}))
    meta = serving.serving_meta(full, "tiny.yaml", batch, exported)
    assert meta["batch_size"] == B and set(meta["inputs"]) == set(batch)
    assert serving.serving_input_spec(full, B, model) == {
        k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
    serving.save_serving(exported, path, meta)
    predict, _ = serving.load_serving(path)
    got = predict(batch)
    want = serving.make_predict_fn(model, cfg)(batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the serve CLI feeds point clouds: it refuses a voxel program
    from pdanet_tpu_torch.tools import serve as serve_cli

    with pytest.raises(SystemExit, match="point detector's program only"):
        serve_cli.main(["--artifact", str(path), "--inputs", str(tmp_path / "*.bin")])


def test_build_network_pointpillar_yaml_and_zoo_raises():
    """The shipped yaml at full width, its grid from the dataset: 321408
    anchors a frame, every leaf of a JAX tree of the same config consumed,
    every parameter and buffer contiguous; every name of the JAX registry
    builds (CaDDN the last), a name it lacks raises KeyError; the dynamic
    VFE and ATSS variants build with the JAX package's device batch (their
    parity: ``tests/test_torch_dynamic_vfe.py``, ``tests/test_torch_atss.py``)."""
    cfg = cfg_from_yaml_file(str(PP_YAML))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert model.anchors_flat.shape == (321408, 7)
    assert model.grid_size == (432, 496, 1) and model.vfe.voxel_size == (0.16, 0.16, 4.0)
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=3, dataset=jds)
    spec = serving.serving_input_spec(cfg, 1, model)
    assert spec["voxels"][0] == (1, 40000, 32, 4)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *(jnp.zeros(s, jnp.float32 if d == torch.float32 else jnp.int32)
                                 for s, d in spec.values()), train=False))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rs.rand(*s.shape).astype(np.float32), shapes)
    load_jax_variables(model, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    # NCCL broadcasts the parameters and buffers as they lie (Gloo copies)
    tensors = [*model.named_parameters(), *model.named_buffers()]
    assert [n for n, t in tensors if not t.is_contiguous()] == []

    from pdanet_tpu.models.detectors import __all__ as j_detectors
    from pdanet_tpu_torch.models.detectors import __all__ as detectors

    assert sorted(detectors) == sorted(j_detectors) and "CaDDN" in detectors
    with pytest.raises(KeyError):
        build_network(EasyDict(NAME="CenterNet"), 3, device="cpu")
    for key, value, keys in (
            ("VFE", {"NAME": "DynamicPillarVFE", "NUM_FILTERS": [16]}, ("points", "gt_boxes")),
            ("DENSE_HEAD.TARGET_ASSIGNER_CONFIG", {"NAME": "ATSS", "TOPK": 9},
             ("voxels", "voxel_coords", "voxel_num_points", "gt_boxes"))):
        variant = EasyDict(PP_MODEL_CFG)
        node = variant
        for part in key.split(".")[:-1]:
            node = node[part]
        node[key.split(".")[-1]] = EasyDict({**node[key.split(".")[-1]], **value})
        port = build_network(variant, 2, class_names=CLASSES, device="cpu", **GEOMETRY)
        jport = j_build(JEasyDict(variant), num_class=2, class_names=CLASSES, **GEOMETRY)
        assert port.DEVICE_BATCH_KEYS == jport.DEVICE_BATCH_KEYS == keys
