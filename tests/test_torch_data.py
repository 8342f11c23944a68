"""The data side of pdanet_tpu_torch against the JAX package, on the CPU.

Both packages run on the synthetic mini-ONCE of ``tests/once_fixture.py``
(two copies of the same generated root, one per package):

* ``create_once_infos``: infos and gt-database infos equal, array for
  array, and each package reads the other's pickles;
* ``__getitem__`` on the test split bit for bit; on the train split (gt
  sampling, world flip, rotation and scaling, the PDA-SSD processors) and
  the loader's collated batches bit for bit under the same
  ``np.random.seed``;
* every point processor, the world augmentors, ``SimpleLoader``'s sample
  plan, point painting and the numpy box utilities, each against its JAX
  twin;
* the official ONCE evaluation: ``get_evaluation_results`` exactly equal
  on perfect and perturbed predictions.

Each package runs its default host path: the points in boxes, the
rotated overlaps and the voxelizer through its own g++ host library
(``pdanet_tpu/native``, ``pdanet_tpu_torch/native``), which
``tests/test_native.py`` and ``tests/test_torch_native.py`` hold to the
numpy plain versions.
"""

import copy
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from once_fixture import build_mini_once
from pdanet_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from pdanet_tpu.datasets import SimpleLoader as JSimpleLoader
from pdanet_tpu.datasets import build_dataloader as j_build_dataloader
from pdanet_tpu.datasets.augmentor import augmentor_utils as j_aug
from pdanet_tpu.datasets.kitti.kitti_object_eval_python import rotate_iou as j_rotate_iou
from pdanet_tpu.datasets.once.once_dataset import ONCEDataset as JONCEDataset
from pdanet_tpu.datasets.once.once_dataset import create_once_infos as j_create_once_infos
from pdanet_tpu.datasets.once.once_eval.evaluation import (
    get_evaluation_results as j_get_evaluation_results,
)
from pdanet_tpu.datasets.processor.data_processor import DataProcessor as JDataProcessor
from pdanet_tpu.utils import box_utils as j_box_utils
from pdanet_tpu.utils import common_utils as j_common
from pdanet_tpu.utils import iou3d_np as j_iou3d_np
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets import SimpleLoader, build_dataloader, get_dataset_class
from pdanet_tpu_torch.datasets.augmentor import augmentor_utils as aug
from pdanet_tpu_torch.datasets.augmentor.data_augmentor import DataAugmentor
from pdanet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
from pdanet_tpu_torch.datasets.kitti.kitti_object_eval_python import rotate_iou
from pdanet_tpu_torch.datasets.once.once_dataset import ONCEDataset, create_once_infos
from pdanet_tpu_torch.datasets.once.once_eval.evaluation import get_evaluation_results
from pdanet_tpu_torch.datasets.processor.data_processor import DataProcessor
from pdanet_tpu_torch.utils import box_utils, common_utils, iou3d_np
from pdanet_tpu_torch.utils.easydict import EasyDict

REPO = Path(__file__).resolve().parent.parent
ONCE_YAML = REPO / "tools" / "cfgs" / "once_models" / "PDA-SSD.yaml"
CLASSES = ["Car", "Bus", "Truck", "Pedestrian", "Cyclist"]
NUM_POINTS = 4096  # the fixture's frames hold ~5450 points


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def data_cfg(root, num_points=NUM_POINTS):
    """The DATA_CONFIG of the ONCE PDA-SSD yaml at ``root``, with the
    ``sample_points`` budget cut to the fixture's frames."""
    cfg = cfg_from_yaml_file(str(ONCE_YAML)).DATA_CONFIG
    cfg.DATA_PATH = str(root)
    for proc in cfg.DATA_PROCESSOR:
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": num_points, "test": num_points}
    return cfg


def j_data_cfg(root, num_points=NUM_POINTS):
    return JEasyDict(copy.deepcopy(dict(data_cfg(root, num_points))))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One mini-ONCE root per package, each with that package's infos and
    gt database."""
    out = {}
    for name, create, cfg_of in (("jax", j_create_once_infos, j_data_cfg),
                                 ("port", create_once_infos, data_cfg)):
        root = tmp_path_factory.mktemp(f"mini_once_{name}")
        build_mini_once(root, num_frames=3)
        create(cfg_of(root), list(CLASSES), root, root, workers=1)
        out[name] = root
    return out


def assert_same(got, want, path="", roots=None):
    """Recursive equality of plain containers of numpy arrays: arrays of the
    same dtype and values, strings equal after mapping the port's root onto
    JAX's."""
    assert type(got) is type(want), f"{path}: {type(got)} != {type(want)}"
    if isinstance(want, dict):
        assert list(got) == list(want), f"{path}: keys {list(got)} != {list(want)}"
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}", roots)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{path}: len {len(got)} != {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", roots)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, f"{path}: {got.dtype} != {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, str) and roots is not None:
        assert got.replace(str(roots["port"]), str(roots["jax"])) == want, path
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


@pytest.mark.parametrize("name", ["once_infos_train.pkl", "once_infos_val.pkl",
                                  "once_infos_test.pkl", "once_dbinfos_train.pkl"])
def test_infos_equal_jax(roots, name):
    with open(roots["port"] / name, "rb") as f:
        got = pickle.load(f)
    with open(roots["jax"] / name, "rb") as f:
        want = pickle.load(f)
    assert len(want) > 0
    assert_same(got, want, name, roots)
    # plain containers only: nothing of either package is pickled
    assert b"pdanet" not in (roots["port"] / name).read_bytes()
    for db_file in (roots["port"] / "gt_database").iterdir():
        assert db_file.read_bytes() == (roots["jax"] / "gt_database" / db_file.name).read_bytes()


def _make(pkg, root, training, num_points=NUM_POINTS):
    if pkg == "port":
        return ONCEDataset(data_cfg(root, num_points), list(CLASSES),
                           training=training, root_path=root)
    return JONCEDataset(j_data_cfg(root, num_points), list(CLASSES),
                        training=training, root_path=root)


def _items(ds, seed):
    out = []
    for i in range(len(ds)):
        np.random.seed(seed + i)
        out.append(ds[i])
    return out


@pytest.mark.parametrize("training", [False, True], ids=["test", "train"])
@pytest.mark.parametrize("root", ["jax", "port"])
def test_getitem_equals_jax(roots, root, training):
    """Both packages on one root's pickles (so each reads the other's):
    the test split bit for bit, the train split (gt sampling, world
    augmentations, mask / sample / shuffle / sort) bit for bit under the
    same seed."""
    got = _items(_make("port", roots[root], training), seed=7)
    want = _items(_make("jax", roots[root], training), seed=7)
    assert_same(got, want, f"{root} training={training}")
    for item in got:
        assert item["points"].shape == (NUM_POINTS, 4)
        assert item["gt_boxes"].shape[1] == 8


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_equal_jax(roots, workers):
    """``build_dataloader`` (B=2, MAX_GT_BOXES 128) over two epochs: the
    sample plan and every collated batch equal JAX's.  Without threads, the
    train split under one seed; with two, the order in which frames draw
    from the global RNG is the threads', so the test split without
    ``sample_points`` (no draw; every point of each frame)."""
    training, num_points = (True, NUM_POINTS) if workers == 0 else (False, -1)
    got, want = [], []
    for build, cfg_of, out in ((build_dataloader, data_cfg, got),
                               (j_build_dataloader, j_data_cfg, want)):
        np.random.seed(3)
        _, loader, _ = build(dataset_cfg=cfg_of(roots["jax"], num_points),
                             class_names=list(CLASSES), batch_size=2, root_path=roots["jax"],
                             workers=workers, seed=5, training=training)
        for epoch in range(2):
            loader.set_epoch(epoch)
            out.append(loader._sample_plan())
            out.extend(loader)
    assert_same(got, want)
    batch = got[1]
    assert batch["gt_boxes"].shape == (2, 128, 8)
    if training:
        assert batch["points"].shape == (2, NUM_POINTS, 4)
    else:
        assert batch["points"].shape[1] > NUM_POINTS


@pytest.mark.parametrize("n,batch,shuffle,world,rank,drop_last", [
    (7, 2, True, 1, 0, None), (7, 2, False, 1, 0, None), (7, 3, True, 2, 1, None),
    (8, 4, False, 3, 2, True), (5, 2, True, 1, 0, False), (1, 2, False, 1, 0, None),
])
def test_sample_plan_equals_jax(n, batch, shuffle, world, rank, drop_last):
    class Stub:
        def __len__(self):
            return n

    for epoch in (0, 3):
        loaders = [cls(Stub(), batch, shuffle, seed=11, rank=rank, world=world,
                       drop_last=drop_last) for cls in (SimpleLoader, JSimpleLoader)]
        for ld in loaders:
            ld.set_epoch(epoch)
        assert loaders[0]._sample_plan() == loaders[1]._sample_plan()
        assert len(loaders[0]) == len(loaders[1])


def _frame(seed, n=3000):
    rs = np.random.RandomState(seed)
    pts = np.concatenate([rs.uniform(-90, 90, (n, 3)), rs.uniform(0, 1, (n, 1))],
                         axis=1).astype(np.float32)
    boxes = np.concatenate([rs.uniform(-80, 80, (12, 3)), rs.uniform(0.5, 5, (12, 3)),
                            rs.uniform(-np.pi, np.pi, (12, 1))], axis=1).astype(np.float32)
    return pts, boxes


@pytest.mark.parametrize("training", [False, True], ids=["test", "train"])
@pytest.mark.parametrize("proc", [
    {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
    {"NAME": "sample_points", "NUM_POINTS": {"train": 1000, "test": 2000}},
    {"NAME": "sample_points", "NUM_POINTS": {"train": 5000, "test": 3000}},
    {"NAME": "sample_points", "NUM_POINTS": {"train": -1, "test": -1}},
    {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": False}},
    {"NAME": "sort_points", "ENABLED": {"train": True, "test": True}},
    {"NAME": "sort_points", "ENABLED": {"train": False, "test": True}},
], ids=lambda p: p["NAME"] + str(p.get("NUM_POINTS", {}).get("train", "")))
def test_point_processor_equals_jax(proc, training):
    pcr = [-75.2, -75.2, -5.0, 75.2, 75.2, 3.0]
    outs = []
    for cls, ed in ((DataProcessor, EasyDict), (JDataProcessor, JEasyDict)):
        pts, boxes = _frame(21)
        np.random.seed(4)
        dp = cls([ed(proc)], point_cloud_range=pcr, training=training, num_point_features=4)
        outs.append(dp.forward({"points": pts, "gt_boxes": boxes}))
    assert_same(outs[0], outs[1])


@pytest.mark.parametrize("name", ["sample_points_by_voxels", "downsample_depth_map"])
def test_unported_processors_raise(name):
    """The two processors the port once refused, now bit for bit the JAX
    package's: ``sample_points_by_voxels`` (``raw`` and ``mean_vfe``, a
    budget under and over the voxel count, and -1) and
    ``downsample_depth_map`` (sides that are and are not multiples of 4)."""
    cases = ([{"NAME": name, "VOXEL_SIZE": [0.8, 0.8, 0.4], "MAX_POINTS_PER_VOXEL": 5,
               "MAX_NUMBER_OF_VOXELS": {"train": 4000, "test": 4000}, "SAMPLE_TYPE": kind,
               "NUM_POINTS": {"train": n, "test": n}}
              for kind in ("raw", "mean_vfe") for n in (1500, 6000, -1)]
             if name == "sample_points_by_voxels" else [{"NAME": name, "DOWNSAMPLE_FACTOR": 4}])
    for training in (False, True):
        for proc in cases:
            outs = []
            for cls, ed in ((DataProcessor, EasyDict), (JDataProcessor, JEasyDict)):
                pts, boxes = _frame(22)
                rs = np.random.RandomState(5)
                frame = {"points": pts, "gt_boxes": boxes,
                         "depth_maps": rs.uniform(0, 80, (375, 1242)).astype(np.float32)}
                np.random.seed(4)
                dp = cls([ed(proc)], point_cloud_range=[-75.2, -75.2, -5.0, 75.2, 75.2, 3.0],
                         training=training, num_point_features=4)
                outs.append(dp.forward(frame))
            assert_same(outs[0], outs[1], str(proc))
    if name == "downsample_depth_map":
        assert outs[0]["depth_maps"].shape == (94, 311)


def test_unported_dataset_and_augmentor_raise(tmp_path):
    """The dataset registry; CaDDN's ``random_image_flip``, the port once
    refused, now bit for bit the JAX package's over seeds that flip and
    seeds that do not (the image, the depth map and the boxes)."""
    from kitti_fixture import CALIB_TXT
    from pdanet_tpu.datasets.augmentor.data_augmentor import DataAugmentor as JDataAugmentor
    from pdanet_tpu.utils.calibration_kitti import Calibration as JCalibration
    from pdanet_tpu_torch.utils.calibration_kitti import Calibration

    assert get_dataset_class("KittiDataset") is KittiDataset
    assert get_dataset_class("ONCEDataset") is ONCEDataset
    with pytest.raises(KeyError):
        get_dataset_class("NuScenesDataset")
    (tmp_path / "calib.txt").write_text(CALIB_TXT)
    cfg = {"DISABLE_AUG_LIST": ["placeholder"], "AUG_CONFIG_LIST": [
        {"NAME": "random_image_flip", "ALONG_AXIS_LIST": ["horizontal"]}]}
    flipped = set()
    for seed in range(6):
        outs = []
        for aug_cls, calib_cls, ed in ((DataAugmentor, Calibration, EasyDict),
                                       (JDataAugmentor, JCalibration, JEasyDict)):
            rs = np.random.RandomState(seed)
            pts, boxes = _frame(40 + seed)
            boxes[:, 0] = np.abs(boxes[:, 0]) + 5.0  # in front of the camera
            frame = {"images": rs.rand(375, 1242, 3).astype(np.float32),
                     "depth_maps": rs.rand(94, 311).astype(np.float32),
                     "gt_boxes": boxes, "gt_names": np.array(["Car"] * len(boxes)),
                     "calib": calib_cls(str(tmp_path / "calib.txt"))}
            np.random.seed(seed)
            outs.append(aug_cls(tmp_path, ed(cfg), CLASSES).forward(frame))
            outs[-1]["draw"] = np.random.randint(1 << 30)  # the same draws consumed
        assert_same(outs[0], outs[1], f"seed {seed}")
        flipped.add(bool((outs[0]["gt_boxes"][:, 6] != _frame(40 + seed)[1][:, 6]).any()))
    assert flipped == {False, True}


@pytest.mark.parametrize("fn,args", [
    ("random_flip_along_x", (0.5,)), ("random_flip_along_y", (0.5,)),
    ("global_rotation", ([-0.78539816, 0.78539816], 0.5)),
    ("global_rotation", ([-0.3, 0.3], 1.0)),
    ("global_scaling", ([0.9, 1.1], 0.5)), ("global_scaling", ([0.95, 1.05], 1.0)),
])
def test_world_augmentor_equals_jax(fn, args):
    for seed in range(6):
        outs = []
        for mod in (aug, j_aug):
            pts, boxes = _frame(30 + seed)
            np.random.seed(seed)
            outs.append(getattr(mod, fn)(boxes, pts, *args))
            outs[-1] += (np.random.randint(1 << 30),)  # the same draws consumed
        assert_same(outs[0], outs[1], f"{fn} seed {seed}")


def test_point_painting_equals_jax(roots):
    from PIL import Image

    outs = []
    for pkg in ("port", "jax"):
        root = roots[pkg]
        with open(root / "once_infos_train.pkl", "rb") as f:
            info = pickle.load(f)[1]
        semseg = root / "semseg"
        rng = np.random.RandomState(7)
        for cam in ("cam01", "cam03"):
            d = semseg / info["sequence_id"] / cam
            d.mkdir(parents=True, exist_ok=True)
            seg = rng.randint(0, 8, (1080, 1920)).astype(np.uint8)
            Image.fromarray(seg).save(d / f"{info['frame_id']}_label.png")
        ds = _make(pkg, root, training=False)
        ds.dataset_cfg.SEMSEG_DIR = str(semseg)
        points = ds.get_lidar(info["sequence_id"], info["frame_id"])
        outs.append(ds.point_painting(points, info))
    assert_same(outs[0], outs[1])
    assert outs[0].shape[1] == 10 and (outs[0][:, 4:].sum(axis=1) > 0.5).sum() > 20


# ---------------------------------------------------------------------------
# numpy box utilities
# ---------------------------------------------------------------------------


def _boxes(seed, n, span=15.0):
    rs = np.random.RandomState(seed)
    return np.column_stack([
        rs.uniform(-span, span, (n, 2)), rs.uniform(-1, 1, n), rs.uniform(0.5, 5, (n, 2)),
        rs.uniform(0.5, 3, n), rs.uniform(-np.pi, np.pi, n)]).astype(np.float32)


UTILS = {
    "limit_period": lambda m: m.limit_period(np.linspace(-9, 9, 37), 0.5, 2 * np.pi),
    "rotate_points_along_z_np": lambda m: m.rotate_points_along_z_np(
        _boxes(1, 12).reshape(2, 6, 7), np.array([0.3, -1.2])),
    "drop_info_with_name": lambda m: m.drop_info_with_name(
        {"name": np.array(["Car", "DontCare", "Bus"]), "boxes_3d": _boxes(2, 3),
         "meta": "x"}, "DontCare"),
    "keep_arrays_by_name": lambda m: m.keep_arrays_by_name(
        np.array(["Car", "Van", "Cyclist", "Car"]), ["Car", "Cyclist"]),
}
BOX_UTILS = {
    "boxes_to_corners_3d": lambda m: m.boxes_to_corners_3d(_boxes(3, 9)),
    "enlarge_box3d": lambda m: m.enlarge_box3d(_boxes(4, 5), [0.2, 0.3, 0.4]),
    "mask_points_by_range": lambda m: m.mask_points_by_range(
        _boxes(5, 50, 80)[:, :3], [-75.2, -75.2, -5, 75.2, 75.2, 3]),
    "mask_boxes_outside_range_numpy": lambda m: m.mask_boxes_outside_range_numpy(
        _boxes(6, 40, 20), [-15, -15, -1, 15, 15, 1], 3),
    "points_in_boxes_cpu": lambda m: m.points_in_boxes_cpu(
        _boxes(7, 4000, 15)[:, :3], _boxes(8, 30)),
    "remove_points_in_boxes3d": lambda m: m.remove_points_in_boxes3d(
        _boxes(9, 3000, 15)[:, :4], _boxes(10, 20)),
}


@pytest.mark.parametrize("name", list(UTILS) + list(BOX_UTILS) + ["boxes_bev_iou_cpu"] + [
    f"rotate_iou_eval{c}" for c in (-1, 0, 1, 2)])
def test_box_utils_equal_jax(name):
    if name in UTILS:
        got, want = UTILS[name](common_utils), UTILS[name](j_common)
    elif name in BOX_UTILS:
        got, want = BOX_UTILS[name](box_utils), BOX_UTILS[name](j_box_utils)
    elif name == "boxes_bev_iou_cpu":
        a, b = _boxes(11, 25, 6), _boxes(12, 20, 6)
        got, want = iou3d_np.boxes_bev_iou_cpu(a, b), j_iou3d_np.boxes_bev_iou_cpu(a, b)
        assert (want > 0).sum() > 10
    else:
        crit = int(name[len("rotate_iou_eval"):])
        a = _boxes(13, 50, 6)[:, [0, 1, 3, 4, 6]].astype(np.float64)
        b = _boxes(14, 40, 6)[:, [0, 1, 3, 4, 6]].astype(np.float64)
        got = rotate_iou.rotate_iou_eval(a, b, crit)
        want = j_rotate_iou.rotate_iou_eval(a, b, crit)
    assert_same(got, want, name)


def test_create_logger_and_seed(tmp_path):
    log = common_utils.create_logger(tmp_path / "log.txt")
    log.info("hello")
    assert "hello" in (tmp_path / "log.txt").read_text()
    common_utils.set_random_seed(5)
    a = np.random.rand(3)
    j_common.set_random_seed(5)
    np.testing.assert_array_equal(a, np.random.rand(3))


# ---------------------------------------------------------------------------
# the official ONCE evaluation
# ---------------------------------------------------------------------------


def _eval_annos(perturbed, seed=0, frames=6):
    """gt over 0-30 / 30-50 / 50+ m and all five classes; the predictions
    are the gt itself or the gt jittered, partly dropped, partly relabelled,
    with false positives and random scores."""
    rs = np.random.RandomState(seed)
    gt_annos, det_annos = [], []
    for _ in range(frames):
        n = 12
        r = rs.uniform(5, 70, n)
        phi = rs.uniform(-np.pi, np.pi, n)
        boxes = np.stack([r * np.cos(phi), r * np.sin(phi), rs.uniform(-1, 1, n),
                          rs.uniform(1.5, 8, n), rs.uniform(1.5, 3, n),
                          rs.uniform(1.2, 3.5, n), rs.uniform(-np.pi, np.pi, n)], axis=-1)
        names = np.array([CLASSES[i] for i in rs.randint(0, 5, n)])
        gt_annos.append({"name": names, "boxes_3d": boxes})
        if not perturbed:
            det_annos.append({"name": names.copy(), "boxes_3d": boxes.copy(),
                              "score": np.full(n, 0.9)})
            continue
        keep = rs.rand(n) > 0.2
        det = boxes[keep] + rs.normal(0, 0.15, (keep.sum(), 7))
        det_names = names[keep].copy()
        swap = rs.rand(len(det_names)) < 0.15
        det_names[swap] = rs.choice(CLASSES, swap.sum())
        fp = np.stack([rs.uniform(-60, 60, 4), rs.uniform(-60, 60, 4), rs.uniform(-1, 1, 4),
                       rs.uniform(1, 5, 4), rs.uniform(1, 3, 4), rs.uniform(1, 3, 4),
                       rs.uniform(-np.pi, np.pi, 4)], axis=-1)
        det_annos.append({
            "name": np.concatenate([det_names, rs.choice(CLASSES, 4)]),
            "boxes_3d": np.concatenate([det, fp]),
            "score": np.round(rs.rand(len(det_names) + 4), 2)})
    return gt_annos, det_annos


@pytest.mark.parametrize("perturbed", [False, True], ids=["perfect", "perturbed"])
@pytest.mark.parametrize("kwargs", [
    {}, {"use_superclass": False}, {"difficulty_mode": "Overall"},
    {"difficulty_mode": "Distance", "ap_with_heading": False, "num_parts": 4},
], ids=["default", "classes", "overall", "distance"])
def test_once_evaluation_equals_jax(perturbed, kwargs):
    gt, det = _eval_annos(perturbed)
    got = get_evaluation_results(copy.deepcopy(gt), copy.deepcopy(det), list(CLASSES), **kwargs)
    want = j_get_evaluation_results(gt, det, list(CLASSES), **kwargs)
    assert got[0] == want[0]
    assert list(got[1]) == list(want[1])
    for k in want[1]:
        assert got[1][k] == want[1][k], k
    if not perturbed:  # AP 100, or 0 where a class has no gt at that range
        per_class = [v for k, v in want[1].items() if not k.startswith("AP_mean")]
        assert max(per_class) > 99.0 and all(v == 0 or v > 99.0 for v in per_class), want[0]
