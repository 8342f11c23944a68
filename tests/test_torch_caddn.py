"""CaDDN in pdanet_tpu_torch against the JAX package, on the CPU, at the
tiny config of ``tests/test_caddn.py`` (a 16 x 16 x 4 grid, DDN width 16,
8 LID bins), inputs from numpy seeds, weights carried from the flax
variables by the weight bridge.  The JAX side runs jitted: XLA compiles a
quotient by a constant as a product with its reciprocal, which the port
computes so.

* ``bin_depths`` (UD, LID, SID): the targets equal, the float bins within
  2e-5; ``compute_fg_mask`` equal; ``normalize_coords`` equal;
  ``project_to_image`` within 1e-5 of max(1, |value|) away from the image
  plane (XLA's dot sums in another order).
* The frustum features within 1e-6; the sampler (``F.grid_sample``, 3-D,
  align_corners False, zero padding) within 1e-6 of JAX's gather-based
  ``trilinear_sample`` (its weights round as fz * fy * fx); the
  frustum-to-voxel geometry on the synthetic calibration within 2e-5.
* flax's 'SAME' padding: the 7 x 7 / 2 stem and the 3 x 3 / 2 max-pool on
  an image with an even and an odd side; ``F.interpolate`` against
  ``jax.image.resize`` at 47 x 156 -> 94 x 311 within 2e-6.
* CaDDN at eval in float32 on two frames of 30 x 63 pixels: the depth
  logits, the voxel features, the BEV map and the head's logits within
  1e-4 of max(1, |value|); in training mode in float64: the loss and its
  terms within 1e-9 relative, every gradient leaf within 1e-8 of its
  largest |gradient| (the sampler's backward sums in another order), the
  running statistics within 1e-10.
* The shipped ``CaDDN.yaml`` through ``build_network`` with the dataset's
  grid, filled by a JAX tree of the same config (every leaf consumed);
  ``serving_input_spec`` refuses it as the JAX package's does.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu import serving as j_serving
from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.backbones_3d.vfe import image_vfe as JIV
from pdanet_tpu.utils import transform_utils as JTU
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d.vfe import image_vfe as IV
from pdanet_tpu_torch.utils import transform_utils as TU
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_caddn import CADDN_MODEL_CFG, DISC, GRID, PC_RANGE, _calib
from test_torch_pointpillar import _flat, _perturb, _stats_close

REPO = Path(__file__).resolve().parent.parent
CADDN_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "CaDDN.yaml"
CLASSES = ("Car", "Pedestrian")
GEOMETRY = dict(grid_size=GRID, voxel_size=(0.4, 0.4, 1.0), point_cloud_range=PC_RANGE,
                class_names=CLASSES)
H, W = 30, 63  # an even and an odd side: the stem pads (2, 3) and (3, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, f"{what}: {err.max():.3g} > {tol}"


def test_transform_utils_equal_jax():
    rs = np.random.RandomState(0)
    depth = rs.uniform(-1.0, 60.0, 4000).astype(np.float32)
    depth[:3] = [np.nan, np.inf, 46.8]
    for mode in ("UD", "LID", "SID"):
        for target in (False, True):
            want = jax.jit(lambda d: JTU.bin_depths(d, mode, 2.0, 46.8, 80, target=target))(depth)
            got = TU.bin_depths(torch.from_numpy(depth), mode, 2.0, 46.8, 80, target=target)
            if target:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=mode)
            else:
                ok = np.isfinite(np.asarray(want))
                _close(got.numpy()[ok], np.asarray(want)[ok], 2e-5, mode)
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[0, 0] = [4.0, 8.0, 12.0, 16.0]
    boxes[0, 2] = [10.3, 5.1, 30.7, 20.2]
    boxes[1, 1] = [0.5, 2.0, 63.0, 31.0]
    want = jax.jit(lambda b: JTU.compute_fg_mask(b, (2, 8, 16), 4))(boxes)
    np.testing.assert_array_equal(
        TU.compute_fg_mask(torch.from_numpy(boxes), (2, 8, 16), 4).numpy(), np.asarray(want))
    coords = rs.uniform(-5, 400, (1000, 3)).astype(np.float32)
    want = jax.jit(lambda c: JTU.normalize_coords(c, jnp.asarray([80, 94, 311], jnp.float32)))(
        coords)
    np.testing.assert_array_equal(TU.normalize_coords(torch.from_numpy(coords),
                                                      (80, 94, 311)).numpy(), np.asarray(want))
    proj = rs.uniform(-1, 1, (3, 4)).astype(np.float32)
    proj[2, 2] += 3.0
    pts = rs.uniform(-10, 10, (1000, 3)).astype(np.float32)
    pts = pts[np.abs(pts @ proj[2, :3] + proj[2, 3]) > 0.5]  # away from the image plane
    want_img, want_depth = jax.jit(JTU.project_to_image)(proj, pts)
    got_img, got_depth = TU.project_to_image(torch.from_numpy(proj), torch.from_numpy(pts))
    _close(got_img.numpy(), want_img, 1e-5, "pixels")
    _close(got_depth.numpy(), want_depth, 1e-5, "depths")


def test_frustum_features_and_sampler_equal_jax():
    rs = np.random.RandomState(1)
    feats = rs.rand(2, 4, 6, 3).astype(np.float32)
    logits = rs.randn(2, 4, 6, 5).astype(np.float32)
    want = jax.jit(JIV.create_frustum_features)(feats, logits)  # (B, D, H, W, C)
    got = IV.create_frustum_features(torch.from_numpy(feats), torch.from_numpy(logits))
    _close(got.permute(0, 2, 3, 4, 1).numpy(), want, 1e-6, "frustum")

    vol = rs.randn(5, 6, 7, 3).astype(np.float32)  # (D, H, W, C)
    g = rs.uniform(-1.3, 1.3, (500, 3)).astype(np.float32)
    g[:8] = [[-1, -1, -1], [1, 1, 1], [-2, -2, -2], [0.99, -0.99, 0], [1.2, 0, 0],
             [0, -1.15, 0.3], [-1 + 1 / 7, -1 + 1 / 6, -1 + 1 / 5], [0, 0, 0]]
    want = jax.jit(JIV.trilinear_sample)(vol, g[:, 0], g[:, 1], g[:, 2])
    got = torch.nn.functional.grid_sample(
        torch.from_numpy(vol).permute(3, 0, 1, 2)[None], torch.from_numpy(g)[None, None, None],
        mode="bilinear", padding_mode="zeros", align_corners=False)[0, :, 0, 0].t()
    _close(got.numpy(), want, 1e-6, "trilinear sample")

    # the JAX test's geometry: a frustum holding its own (d, v, u) indices
    l2c, c2i = _calib()
    D, Hf, Wf = DISC["num_bins"], 32, 64
    frustum = np.zeros((1, D, Hf, Wf, 3), np.float32)
    frustum[0, ..., 0] = np.arange(D)[:, None, None]
    frustum[0, ..., 1] = np.arange(Hf)[None, :, None]
    frustum[0, ..., 2] = np.arange(Wf)[None, None, :]
    f2v = JIV.FrustumToVoxel(GRID, PC_RANGE, DISC)
    want = jax.jit(lambda f, a, b: f2v(f, a, b, (Hf, Wf)))(frustum, l2c[None], c2i[None])
    got = IV.FrustumToVoxel(GRID, PC_RANGE, DISC)(
        torch.from_numpy(frustum).permute(0, 4, 1, 2, 3), torch.from_numpy(l2c)[None],
        torch.from_numpy(c2i)[None], (Hf, Wf))
    assert float(np.abs(np.asarray(want)).max()) > 1.0  # voxels in the frustum
    _close(got.permute(0, 2, 3, 4, 1).numpy(), want, 2e-5, "frustum to voxel")


def test_same_padding_pool_and_resize_equal_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(1, H, W, 3).astype(np.float32)
    stem = JIV.ConvBNReLU(4, 7, 2)
    variables = _perturb(jax.jit(lambda a: stem.init(jax.random.PRNGKey(0), a))(x), 1)
    want = jax.jit(lambda v, a: stem.apply(v, a))(variables, x)
    port = IV.ConvBNReLU(3, 4, 7, 2).eval()
    load_jax_variables(port, variables)
    got = port(torch.from_numpy(x))
    assert tuple(got.shape) == (1, 15, 32, 4)
    _close(got.detach().numpy(), want, 1e-5, "stem")
    import flax.linen as fnn

    want = jax.jit(lambda a: fnn.max_pool(a, (3, 3), strides=(2, 2), padding="SAME"))(x)
    _close(IV.max_pool_same(torch.from_numpy(x)).numpy(), want, 0.0, "max-pool")
    logits = rs.randn(1, 47, 156, 5).astype(np.float32)
    want = jax.jit(lambda a: jax.image.resize(a, (1, 94, 311, 5), method="bilinear"))(logits)
    got = torch.nn.functional.interpolate(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                          size=(94, 311), mode="bilinear", align_corners=False)
    _close(got.permute(0, 2, 3, 1).numpy(), want, 2e-6, "bilinear resize")


def _frames(seed=3, B=2):
    rs = np.random.RandomState(seed)
    l2c, c2i = _calib()
    gt = np.zeros((B, 3, 8), np.float32)
    gt[0, 0] = [5.0, 0.5, -0.8, 3.9, 1.6, 1.56, 0.3, 1]
    gt[0, 1] = [4.0, -1.0, -0.2, 0.8, 0.6, 1.73, -0.5, 2]
    gt[1, 0] = [6.5, 1.2, -0.9, 3.6, 1.5, 1.5, -1.2, 1]
    boxes2d = np.zeros((B, 2, 4), np.float32)
    boxes2d[0, 0] = [10, 5, 30, 20]
    boxes2d[1, 1] = [30, 2, 62, 29]
    return {"images": rs.rand(B, H, W, 3).astype(np.float32),
            "trans_lidar_to_cam": np.repeat(l2c[None], B, axis=0),
            "trans_cam_to_img": np.repeat(c2i[None], B, axis=0),
            "depth_maps": rs.uniform(1.0, 9.0, (B, 8, 16)).astype(np.float32),
            "gt_boxes2d": boxes2d, "gt_boxes": gt}


CAMERA = ("images", "trans_lidar_to_cam", "trans_cam_to_img")


@pytest.fixture(scope="module")
def caddn_run():
    """The tiny JAX CaDDN at eval in float32, with perturbed weights, and a
    port model holding the same weights."""
    jmodel = j_build(JEasyDict(CADDN_MODEL_CFG), num_class=len(CLASSES), **GEOMETRY)
    batch = _frames()
    args = [batch[k] for k in CAMERA]
    variables = jax.jit(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a))(*args)
    variables = _perturb(variables, 5)

    def fwd(v, *a):
        out = jmodel.apply(v, *a, train=False)
        vfe = jmodel.apply(v, *a, method=lambda m, *x: m.vfe(*x, train=False))
        bev = jmodel.apply(v, vfe["voxel_features"],
                           method=lambda m, x: m.map_to_bev(x, train=False))
        return out, vfe["voxel_features"], bev

    out, voxels, bev = jax.jit(fwd)(variables, *args)
    model = build_network(EasyDict(CADDN_MODEL_CFG), len(CLASSES), device="cpu",
                          **GEOMETRY).eval()
    load_jax_variables(model, variables)
    return dict(jmodel=jmodel, batch=batch, variables=variables, out=jax.device_get(out),
                voxels=np.asarray(voxels), bev=np.asarray(bev), model=model)


def test_caddn_eval_matches_jax(caddn_run):
    model, batch = caddn_run["model"], caddn_run["batch"]
    with torch.no_grad():
        args = [torch.from_numpy(batch[k]) for k in CAMERA]
        vfe = model.vfe(*args)
        bev = model.map_to_bev(vfe["voxel_features"])
        out = model(*args)
    want = caddn_run["out"]
    assert float(np.abs(caddn_run["voxels"]).max()) > 0.1
    _close(vfe["voxel_features"].numpy(), caddn_run["voxels"], 1e-4, "voxel features")
    _close(bev.numpy(), caddn_run["bev"], 1e-4, "BEV map")
    for key in ("depth_logits", "cls_preds", "box_preds", "dir_cls_preds", "batch_cls_preds",
                "batch_box_preds"):
        _close(out[key].numpy(), want[key], 1e-4, key)
    assert tuple(out["depth_logits"].shape) == (2, 8, 16, DISC["num_bins"] + 1)


@pytest.fixture(scope="module")
def caddn_f64(caddn_run):
    """JAX's float64 loss, its terms, gradients and running statistics in
    training mode."""
    jax.config.update("jax_enable_x64", True)
    try:
        jmodel = caddn_run["jmodel"]
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                           caddn_run["variables"])
        batch = {k: np.asarray(v, np.float64) for k, v in caddn_run["batch"].items()}

        def loss_fn(params, b):
            out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    *(b[k] for k in CAMERA), train=True,
                                    mutable=["batch_stats"])
            loss, tb = jmodel.apply(variables, out, b["gt_boxes"], list(CLASSES),
                                    depth_maps=b["depth_maps"], gt_boxes2d=b["gt_boxes2d"],
                                    method=jmodel.loss)
            return loss, (tb, mut["batch_stats"])

        (loss, (tb, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], batch)
        return dict(variables=variables, batch=batch, loss=float(loss),
                    tb={k: float(v) for k, v in tb.items()},
                    grads=jax.device_get(grads), stats=jax.device_get(stats))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_caddn_loss_and_gradients_match_jax_float64(caddn_f64):
    model = build_network(EasyDict(CADDN_MODEL_CFG), len(CLASSES), device="cpu",
                          **GEOMETRY).double()
    load_jax_variables(model, caddn_f64["variables"])
    model.train()
    batch = {k: torch.from_numpy(v) for k, v in caddn_f64["batch"].items()}
    loss, tb = model.loss_batch(model.forward_batch(batch), batch)
    loss.backward()
    tb = {k: float(v) for k, v in tb.items()}
    assert abs(loss.item() - caddn_f64["loss"]) <= 1e-9 * abs(caddn_f64["loss"])
    assert set(tb) == set(caddn_f64["tb"]) and caddn_f64["tb"]["ddn_loss"] > 0
    for k, w in caddn_f64["tb"].items():
        assert abs(tb[k] - w) <= 1e-9 * max(abs(w), 1e-3), k
    ref = build_network(EasyDict(CADDN_MODEL_CFG), len(CLASSES), device="cpu",
                        **GEOMETRY).double()
    load_jax_variables(ref, {"params": caddn_f64["grads"],
                             "batch_stats": caddn_f64["variables"]["batch_stats"]})
    want = dict(ref.named_parameters())
    worst = []
    for name, p in model.named_parameters():
        scale = want[name].abs().max().item()
        worst.append(((p.grad - want[name]).abs().max().item() / max(scale, 1e-12), name))
    worst.sort(reverse=True)
    assert worst[0][0] <= 1e-8, f"gradients, worst first: {worst[:4]}"
    assert any(n.startswith("vfe.ddn.") and w > 0 for w, n in
               ((want[n].abs().max().item(), n) for n in want))
    _stats_close(model, caddn_f64["stats"], atol=1e-10)


def test_caddn_yaml_builds_with_the_jax_tree_and_serving_refuses():
    cfg = cfg_from_yaml_file(str(CADDN_YAML))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert model.grid_size == (280, 376, 25)
    assert model.anchors_flat.shape == (140 * 188 * 6, 7)
    assert model.map_to_bev.block.weight.shape == (64, 25 * 64, 1, 1)
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=3, dataset=jds)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 375, 1242, 3)), jnp.zeros((1, 4, 4)),
        jnp.zeros((1, 3, 4))))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rs.rand(*s.shape).astype(np.float32), shapes)
    load_jax_variables(model, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    torch.testing.assert_close(model.map_to_bev.block.weight[:, :, 0, 0], torch.from_numpy(
        np.asarray(variables["params"]["map_to_bev"]["block"]["kernel"])[0, 0].T),
        rtol=0, atol=0)
    assert _flat(variables["params"]).keys() >= {"vfe/ddn/stem/Conv_0/kernel"}
    with pytest.raises(NotImplementedError, match="camera-family CaDDN"):
        j_serving.serving_input_spec(cfg, 1, jmodel)
    with pytest.raises(NotImplementedError, match="camera-family CaDDN"):
        serving.serving_input_spec(cfg, 1, model)


def test_png_reader_equals_pil(tmp_path):
    """``utils/png.read_png`` against PIL: 8-bit gray, gray + alpha, RGB and
    RGBA and 16-bit gray, every row filter (None, Sub, Up, Average, Paeth)
    written by ``encode_png``, and PIL's own files (its filters)."""
    from PIL import Image

    from pdanet_tpu_torch.utils.png import encode_png, read_png

    rs = np.random.RandomState(0)
    path = tmp_path / "t.png"
    for shape, dtype in (((37, 53, 3), np.uint8), ((20, 31), np.uint8), ((21, 17, 4), np.uint8),
                         ((9, 11, 2), np.uint8), ((19, 23), np.uint16)):
        arr = np.cumsum(rs.randint(0, 1 << (8 * np.dtype(dtype).itemsize), shape), axis=1)
        arr = arr.astype(dtype)
        for filter_type in range(5):
            path.write_bytes(encode_png(arr, filter_type))
            got = read_png(path)
            np.testing.assert_array_equal(got, arr)
            np.testing.assert_array_equal(got.astype(np.int64),
                                          np.asarray(Image.open(path)).astype(np.int64))
        Image.fromarray(arr).save(path, optimize=True)
        np.testing.assert_array_equal(read_png(path).astype(np.int64),
                                      np.asarray(Image.open(path)).astype(np.int64))


def add_camera_inputs(root, ids, sizes, seed=0):
    """CaDDN's camera inputs for the frames ``ids`` of a mini-KITTI root,
    written by PIL: textured RGB ``image_2`` PNGs, frame i of size
    ``sizes[i % len(sizes)]`` (H, W), and 16-bit ``depth_2`` PNGs (metres
    x 256, 0 where no depth) of the same size."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    (Path(root) / "training" / "depth_2").mkdir(parents=True, exist_ok=True)
    for i, idx in enumerate(ids):
        h, w = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 7 + yy * 3) % 256, (yy * 5) % 256, rs.randint(0, 256, (h, w))], -1)
        Image.fromarray(img.astype(np.uint8)).save(Path(root) / "training" / "image_2"
                                                   / f"{idx}.png")
        depth = (rs.uniform(2.0, 60.0, (h, w)) * 256).astype(np.uint16)
        depth[rs.rand(h, w) < 0.7] = 0  # sparse, as projected lidar is
        Image.fromarray(depth).save(Path(root) / "training" / "depth_2" / f"{idx}.png")


def camera_data_cfg(cfg_module, root):
    """The shipped CaDDN.yaml's DATA_CONFIG over ``root``."""
    cfg = cfg_module.cfg_from_yaml_file(str(CADDN_YAML))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    return cfg


def test_kitti_camera_getitem_and_collate_equal_jax(tmp_path):
    """The KITTI dataset's camera inputs through CaDDN.yaml's pipeline
    (the image flip, the 4 x depth downsample) against the JAX package's on
    the same root and infos: every frame's dict and the collated batch of
    a 375 x 1242 and a 370 x 1224 frame (padded to the larger) bit for bit,
    on the test split and on the train split under one ``np.random.seed``."""
    from kitti_fixture import build_mini_kitti
    from pdanet_tpu import config as j_config
    from pdanet_tpu.datasets.kitti.kitti_dataset import KittiDataset as JKittiDataset
    from pdanet_tpu_torch import config
    from pdanet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset, create_kitti_infos
    from test_torch_data import assert_same

    root = tmp_path / "kitti"
    ids = build_mini_kitti(root, num_frames=2, n_bg=500)
    add_camera_inputs(root, ids, [(375, 1242), (370, 1224)])
    cfg = camera_data_cfg(config, root)
    create_kitti_infos(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), root, root, workers=1)
    jcfg = camera_data_cfg(j_config, root)
    for training in (False, True):
        batches = []
        for cls, c in ((KittiDataset, cfg), (JKittiDataset, jcfg)):
            ds = cls(c.DATA_CONFIG, list(c.CLASS_NAMES), training=training, root_path=root)
            np.random.seed(3)
            frames = [ds[i] for i in range(len(ds))]
            for f in frames:
                f.pop("calib", None)  # the packages' own Calibration classes
            batches.append((frames, ds.collate_batch(frames)))
        assert_same(batches[0][0], batches[1][0], f"frames, training {training}")
        assert_same(batches[0][1], batches[1][1], f"batch, training {training}")
        batch = batches[0][1]
        assert batch["images"].shape == (2, 375, 1242, 3)
        assert batch["depth_maps"].shape == (2, 94, 311)
        assert batch["trans_cam_to_img"].shape == (2, 3, 4) and "points" not in batch
        assert (batch["images"][1, 370:] == 0).all() and batch["images"][1, :370].max() > 0.9
