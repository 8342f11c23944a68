"""The KITTI slice of pdanet_tpu_torch against the JAX package, on the CPU,
each package on its default host path (its own g++ host library).

* Calibration (lidar <-> rect <-> image) and the KITTI camera box
  conversions: equal, array for array.
* ``object3d_kitti`` label parsing and difficulty levels: equal.
* The image shape read from the PNG header: equal to PIL's on the
  fixture's images; a file that is not a PNG raises.
* ``create_kitti_infos``: infos, db infos and the gt-database files equal.
* ``KittiDataset.__getitem__`` with the shipped yaml's full augmentor and
  processors, train and test split, and the collated batch: equal under
  one seed.
* ``generate_prediction_dicts``: equal dicts and equal txt files.
* ``get_official_eval_result``: the result string and every number of the
  dict equal, on synthetic gt / dt annos with hits at every difficulty;
  the offline ``evaluate`` over label and result txt files equal.
"""

import copy
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kitti_fixture import CALIB_TXT, build_mini_kitti
from pdanet_tpu.datasets.kitti import kitti_dataset as j_kitti
from pdanet_tpu.datasets.kitti.kitti_object_eval_python import eval as j_eval
from pdanet_tpu.datasets.kitti.kitti_object_eval_python import evaluate as j_evaluate
from pdanet_tpu.utils import box_utils as j_box_utils
from pdanet_tpu.utils import calibration_kitti as j_calibration
from pdanet_tpu.utils import object3d_kitti as j_object3d
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets import build_dataloader
from pdanet_tpu_torch.datasets.kitti import kitti_dataset
from pdanet_tpu_torch.datasets.kitti.kitti_object_eval_python import eval as kitti_eval
from pdanet_tpu_torch.datasets.kitti.kitti_object_eval_python import evaluate
from pdanet_tpu_torch.utils import box_utils, calibration_kitti, object3d_kitti

REPO = Path(__file__).resolve().parent.parent
KITTI_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "PDA-SSD.yaml"
CLASSES = ["Car", "Pedestrian", "Cyclist"]
N_POINTS = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def assert_same(a, b, path="root"):
    """Equal nested dicts / lists of arrays, same dtypes."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _calibs(tmp_path):
    f = tmp_path / "calib.txt"
    f.write_text(CALIB_TXT)
    return calibration_kitti.Calibration(str(f)), j_calibration.Calibration(str(f))


def _lidar_boxes(rs, n):
    return np.concatenate([rs.uniform([5, -20, -2], [60, 20, 0], (n, 3)),
                           rs.uniform(0.5, 5, (n, 3)),
                           rs.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)


def test_calibration_and_box_conversions_equal(tmp_path):
    calib, j_calib = _calibs(tmp_path)
    rs = np.random.RandomState(0)
    pts = rs.uniform([-10, -40, -3], [70, 40, 2], (500, 3)).astype(np.float32)
    for name in ("lidar_to_rect", "rect_to_lidar", "rect_to_img", "lidar_to_img"):
        assert_same(getattr(calib, name)(pts), getattr(j_calib, name)(pts), name)
    u, v, d = rs.uniform(0, 1242, 50), rs.uniform(0, 375, 50), rs.uniform(1, 60, 50)
    assert_same(calib.img_to_rect(u, v, d), j_calib.img_to_rect(u, v, d))

    boxes = _lidar_boxes(rs, 40)
    cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
    assert_same(cam, j_box_utils.boxes3d_lidar_to_kitti_camera(boxes, j_calib))
    assert_same(box_utils.boxes3d_kitti_camera_to_lidar(cam, calib),
                j_box_utils.boxes3d_kitti_camera_to_lidar(cam, j_calib))
    np.testing.assert_allclose(box_utils.boxes3d_kitti_camera_to_lidar(cam, calib)[:, :6],
                               boxes[:, :6], atol=1e-4)
    for shape in (None, np.array([375, 1242])):
        assert_same(box_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib, image_shape=shape),
                    j_box_utils.boxes3d_kitti_camera_to_imageboxes(cam, j_calib,
                                                                   image_shape=shape))
    for bottom in (True, False):
        corners = box_utils.boxes3d_to_corners3d_kitti_camera(cam, bottom_center=bottom)
        assert_same(corners,
                    j_box_utils.boxes3d_to_corners3d_kitti_camera(cam, bottom_center=bottom))
    assert_same(calib.corners3d_to_img_boxes(corners), j_calib.corners3d_to_img_boxes(corners))
    assert_same(box_utils.boxes3d_lidar_to_aligned_bev_boxes(boxes),
                j_box_utils.boxes3d_lidar_to_aligned_bev_boxes(boxes))
    hull = box_utils.boxes_to_corners_3d(boxes[:1])[0]
    assert_same(box_utils.in_hull(pts, hull), j_box_utils.in_hull(pts, hull))
    assert box_utils.in_hull(boxes[:1, :3], hull).all()


LABELS = """Car 0.00 0 -1.58 587.01 173.33 614.12 200.12 1.65 1.67 3.64 -0.65 1.71 46.70 -1.59
Pedestrian 0.21 1 0.21 423.17 173.67 433.17 224.03 1.60 0.38 0.30 -5.87 1.63 23.11 -0.03
Cyclist 0.41 2 -2.45 1106.14 166.04 1205.87 207.38 1.72 0.50 1.95 4.59 1.32 45.84 -2.36
Van 0.00 3 1.99 337.88 182.91 374.01 200.03 2.04 1.89 4.61 -16.91 2.09 53.84 1.68
Car 0.00 0 1.55 614.24 181.78 727.31 284.77 1.57 1.73 4.15 1.00 1.75 13.22 1.62 0.87
DontCare -1 -1 -10 503.89 169.71 590.61 190.13 -1 -1 -1 -1000 -1000 -1000 -10
"""


def test_object3d_parsing_equal(tmp_path):
    f = tmp_path / "label.txt"
    f.write_text(LABELS)
    got = object3d_kitti.get_objects_from_label(f)
    want = j_object3d.get_objects_from_label(f)
    assert [o.level for o in got] == [o.level for o in want] == [1, 1, 2, -1, 0, -1]
    for o, w in zip(got, want):
        for k in ("cls_type", "cls_id", "truncation", "occlusion", "alpha", "h", "w", "l",
                  "dis_to_cam", "ry", "score", "level_str", "src"):
            assert getattr(o, k) == getattr(w, k), k
        assert_same(o.box2d, w.box2d)
        assert_same(o.loc, w.loc)
        assert_same(o.generate_corners3d(), w.generate_corners3d())
        assert o.to_kitti_format() == w.to_kitti_format()
    assert got[4].score == 0.87 and got[0].score == -1.0


def test_png_header_shape_equals_pil(tmp_path):
    from PIL import Image

    build_mini_kitti(tmp_path, num_frames=2)
    sizes = [(1242, 375), (1224, 370), (1, 1)]
    files = sorted((tmp_path / "training" / "image_2").glob("*.png"))
    for i, (w, h) in enumerate(sizes[1:]):
        f = tmp_path / f"extra{i}.png"
        Image.new("L", (w, h)).save(f)
        files.append(f)
    for f in files:
        with Image.open(f) as im:
            want = np.array([im.size[1], im.size[0]], np.int32)
        assert_same(kitti_dataset._read_image_shape(f), want)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"GIF89a" + bytes(30))
    with pytest.raises(ValueError, match="not a PNG"):
        kitti_dataset._read_image_shape(bad)


def _yaml_cfg(root, n_points=N_POINTS):
    cfg = cfg_from_yaml_file(str(KITTI_YAML))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": n_points, "test": n_points}
    return cfg.DATA_CONFIG, JEasyDict(copy.deepcopy(dict(cfg.DATA_CONFIG)))


def _frame_objects(n_frames):
    """A Car, a Pedestrian and a Cyclist a frame, each frame's elsewhere,
    so that the gt sampler finds boxes that fit beside a frame's own."""
    return [[("Car", dict(center=[10.0 + 7 * i, 6.0 - 3 * i, -0.8], dims=[3.9, 1.6, 1.56],
                          yaw=0.3 * i, npts=300)),
             ("Pedestrian", dict(center=[8.0 + 4 * i, -5.0 + 2 * i, -0.6],
                                 dims=[0.8, 0.6, 1.73], yaw=-0.5, npts=120)),
             ("Cyclist", dict(center=[25.0 - 3 * i, 9.0 - 4 * i, -0.6], dims=[1.76, 0.6, 1.73],
                              yaw=1.0, npts=150))] for i in range(n_frames)]


@pytest.fixture(scope="module")
def two_roots(tmp_path_factory):
    """One mini-KITTI written twice; the port's infos and gt database in
    one root, the JAX package's in the other."""
    roots = []
    for name, create in (("port", kitti_dataset.create_kitti_infos),
                         ("jax", j_kitti.create_kitti_infos)):
        root = tmp_path_factory.mktemp(f"kitti_{name}")
        build_mini_kitti(root, num_frames=5, frame_objects=_frame_objects(5), n_bg=4000)
        (root / "ImageSets" / "val.txt").write_text("000003\n000004\n")
        dcfg, j_dcfg = _yaml_cfg(root)
        create(dcfg if name == "port" else j_dcfg, CLASSES, root, root, workers=2)
        roots.append(root)
    return roots


def test_create_kitti_infos_equal(two_roots):
    root, j_root = two_roots
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl", "kitti_infos_trainval.pkl",
                 "kitti_infos_test.pkl", "kitti_dbinfos_train.pkl"):
        with open(root / name, "rb") as f:
            got = pickle.load(f)
        with open(j_root / name, "rb") as f:
            want = pickle.load(f)
        assert_same(got, want, name)
    with open(root / "kitti_infos_train.pkl", "rb") as f:
        infos = pickle.load(f)
    assert len(infos) == 5 and infos[0]["image"]["image_shape"].tolist() == [375, 1242]
    assert (infos[0]["annos"]["num_points_in_gt"] > 0).all()
    files = sorted(p.name for p in (root / "gt_database").iterdir())
    assert files == sorted(p.name for p in (j_root / "gt_database").iterdir())
    assert len(files) == 15
    for name in files:
        assert (root / "gt_database" / name).read_bytes() == \
            (j_root / "gt_database" / name).read_bytes()


@pytest.mark.parametrize("training", [True, False])
def test_getitem_and_collate_equal(two_roots, training):
    root, _ = two_roots
    dcfg, j_dcfg = _yaml_cfg(root)
    got_ds = kitti_dataset.KittiDataset(dcfg, CLASSES, training=training, root_path=root)
    want_ds = j_kitti.KittiDataset(j_dcfg, CLASSES, training=training, root_path=root)
    assert len(got_ds) == len(want_ds) == (5 if training else 2)
    for seed in range(3):
        samples = []
        for ds in (got_ds, want_ds):
            np.random.seed(seed)
            frames = [ds[i] for i in range(len(ds))]
            batch = ds.collate_batch(frames)
            samples.append((frames, batch))
        (frames, batch), (j_frames, j_batch) = samples
        for d, jd in [(batch, j_batch)] + list(zip(frames, j_frames)):
            # the augmentor drops the calibration in training
            assert ("calib" in d) == ("calib" in jd) == (not training)
            if not training:
                got, want = d.pop("calib"), jd.pop("calib")
                assert str([c.P2 for c in np.atleast_1d(got)]) == \
                    str([c.P2 for c in np.atleast_1d(want)])
        for f, jf in zip(frames, j_frames):
            assert_same(f, jf)
            assert f["points"].shape == (N_POINTS, 4)
        assert_same(batch, j_batch)
        assert batch["gt_boxes"].shape == (len(frames), dcfg.MAX_GT_BOXES, 8)
        if training:  # gt sampling pasted boxes in, on the road plane
            assert max((b[:, 7] > 0).sum() for b in batch["gt_boxes"]) > 2


def test_kitti_loader_batches(two_roots):
    root, _ = two_roots
    dcfg, _ = _yaml_cfg(root)
    dataset, loader, _ = build_dataloader(dcfg, CLASSES, 2, root_path=root, workers=2,
                                          training=False)
    batches = list(loader)
    assert [b["frame_id"] for b in batches] == [["000003", "000004"]]
    assert len(batches[0]["calib"]) == 2 and batches[0]["points"].shape == (2, N_POINTS, 4)
    assert_same(batches[0]["image_shape"], [np.array([375, 1242], np.int32)] * 2)


def test_threaded_loader_is_reproducible(two_roots):
    """The train split (gt sampling, world flip, rotation and scaling, the
    point sampling and shuffle) through ``SimpleLoader`` with threads: two
    passes over one loader at ``workers=2`` and a pass at ``workers=3`` give
    bit-equal batches, whatever numpy's global RNG holds and however the
    threads interleave (a short switch interval), because each sample draws
    from its own generator (``datasets/random_draws.py``)."""
    root, _ = two_roots
    dcfg, _ = _yaml_cfg(root)

    def passes(workers, n):
        np.random.seed(100 + workers)  # the global RNG takes no part
        _, loader, _ = build_dataloader(dcfg, CLASSES, 2, root_path=root, workers=workers,
                                        training=True, seed=4)
        loader.set_epoch(1)
        return [list(loader) for _ in range(n)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        first, second = passes(2, 2)
        (third,) = passes(3, 1)
    finally:
        sys.setswitchinterval(old)
    assert len(first) == 2 and first[0]["points"].shape == (2, N_POINTS, 4)
    assert_same(first, second, "second pass")
    assert_same(first, third, "workers=3")
    # the augmentor ran: gt sampling pasted boxes beside each frame's three
    assert max((b["gt_boxes"][..., 7] > 0).sum(axis=1).max() for b in first) > 3


def _pred_dicts(rs, n_frames):
    preds = []
    for n in rs.randint(0, 12, n_frames):
        preds.append({"pred_boxes": _lidar_boxes(rs, n), "pred_scores": rs.rand(n).astype(
            np.float32), "pred_labels": rs.randint(1, 4, n).astype(np.int64)})
    preds[0] = {k: v[:0] for k, v in preds[0].items()}  # a frame with no detection
    return preds


def test_generate_prediction_dicts_equal(tmp_path):
    calib, j_calib = _calibs(tmp_path)
    rs = np.random.RandomState(2)
    preds = _pred_dicts(rs, 4)
    shape = np.array([375, 1242], np.int32)
    outs = []
    for fn, c, out in ((kitti_dataset.KittiDataset.generate_prediction_dicts, calib, "port"),
                       (j_kitti.KittiDataset.generate_prediction_dicts, j_calib, "jax")):
        (tmp_path / out).mkdir()
        batch = {"calib": [c] * 4, "image_shape": [shape] * 4,
                 "frame_id": ["000010", "000011", "000012", "000013"]}
        outs.append(fn(batch, copy.deepcopy(preds), CLASSES, output_path=tmp_path / out))
    assert_same(outs[0], outs[1])
    assert sum(len(a["score"]) for a in outs[0]) > 10
    for frame in ("000010", "000011", "000012", "000013"):
        assert (tmp_path / "port" / f"{frame}.txt").read_text() == \
            (tmp_path / "jax" / f"{frame}.txt").read_text()


def _eval_annos(seed, n_frames=8):
    """gt annos of 10-14 objects a frame (Car, Van, Pedestrian, Cyclist,
    one DontCare) at every difficulty, and dt annos: most gt boxes
    jittered with scores, some missed, some false positives."""
    rs = np.random.RandomState(seed)
    names = np.array(["Car", "Car", "Van", "Pedestrian", "Pedestrian", "Cyclist"])
    dims = {"Car": [3.9, 1.56, 1.6], "Van": [5.0, 2.0, 1.9], "Pedestrian": [0.8, 1.73, 0.6],
            "Cyclist": [1.76, 1.73, 0.6]}
    gt_annos, dt_annos = [], []
    for _ in range(n_frames):
        n = rs.randint(10, 15)
        name = rs.choice(names, n)
        loc = np.stack([rs.uniform(-15, 15, n), rs.uniform(1.4, 1.8, n),
                        rs.uniform(5, 60, n)], -1)
        dim = np.array([dims[k] for k in name]) * rs.uniform(0.9, 1.1, (n, 3))
        ry = rs.uniform(-np.pi, np.pi, n)
        x1, y1 = rs.uniform(0, 1100, n), rs.uniform(100, 250, n)
        height = rs.choice([20.0, 30.0, 45.0, 80.0], n)
        bbox = np.stack([x1, y1, x1 + rs.uniform(20, 120, n), y1 + height], -1)
        gt = {"name": np.append(name, "DontCare"),
              "truncated": np.append(rs.choice([0.0, 0.0, 0.2, 0.4, 0.6], n), -1),
              "occluded": np.append(rs.choice([0, 0, 1, 2, 3], n), -1),
              "alpha": np.append(rs.uniform(-np.pi, np.pi, n), -10),
              "bbox": np.concatenate([bbox, [[500, 170, 590, 190]]]),
              "dimensions": np.concatenate([dim, [[-1, -1, -1]]]),
              "location": np.concatenate([loc, [[-1000, -1000, -1000]]]),
              "rotation_y": np.append(ry, -10), "score": np.full(n + 1, -1.0)}
        keep = rs.rand(n) < 0.8
        m = int(keep.sum())
        n_fp = rs.randint(1, 4)
        fp_name = rs.choice(["Car", "Pedestrian", "Cyclist"], n_fp)
        dt = {"name": np.concatenate([np.where(name[keep] == "Van", "Car", name[keep]),
                                      fp_name]),
              "truncated": np.zeros(m + n_fp), "occluded": np.zeros(m + n_fp),
              "alpha": np.concatenate([gt["alpha"][:n][keep] + rs.normal(0, 0.2, m),
                                       rs.uniform(-np.pi, np.pi, n_fp)]),
              "bbox": np.concatenate([bbox[keep] + rs.normal(0, 1, (m, 4)),
                                      np.tile([[600, 150, 650, 200]], (n_fp, 1))]),
              "dimensions": np.concatenate([dim[keep] * rs.uniform(0.95, 1.05, (m, 3)),
                                            np.tile([[3.9, 1.56, 1.6]], (n_fp, 1))]),
              "location": np.concatenate([loc[keep] + rs.normal(0, 0.1, (m, 3)),
                                          rs.uniform([-15, 1.4, 5], [15, 1.8, 60], (n_fp, 3))]),
              "rotation_y": np.concatenate([ry[keep] + rs.normal(0, 0.05, m),
                                            rs.uniform(-np.pi, np.pi, n_fp)]),
              "score": rs.rand(m + n_fp)}
        gt_annos.append(gt)
        dt_annos.append(dt)
    return gt_annos, dt_annos


@pytest.mark.parametrize("classes", [CLASSES, ["Car"], [0, 1, 2]])
def test_official_eval_equal(classes):
    gt, dt = _eval_annos(7)
    got_str, got = kitti_eval.get_official_eval_result(copy.deepcopy(gt), copy.deepcopy(dt),
                                                       classes)
    want_str, want = j_eval.get_official_eval_result(copy.deepcopy(gt), copy.deepcopy(dt),
                                                     classes)
    assert got_str == want_str
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k] == w, k
    # hits at every difficulty: nonzero 3-D AP at easy, moderate and hard
    for level in ("easy", "moderate", "hard"):
        assert got[f"Car_3d/{level}_R40"] > 0, level
    assert 0 < got["Car_3d/moderate_R40"] < 100


def test_offline_evaluate_equal(tmp_path):
    """``evaluate.evaluate`` over the fixture's label files and result txts
    written by ``generate_prediction_dicts``: the jittered labels with
    scores, and false positives."""
    ids = build_mini_kitti(tmp_path, num_frames=3)
    split = tmp_path / "ImageSets" / "val.txt"
    calib, _ = _calibs(tmp_path)
    rs = np.random.RandomState(4)
    preds = []
    for idx in ids:
        objs = object3d_kitti.get_objects_from_label(tmp_path / "training" / "label_2"
                                                     / f"{idx}.txt")
        cam = np.array([[*o.loc, o.l, o.h, o.w, o.ry] for o in objs], np.float32)
        boxes = box_utils.boxes3d_kitti_camera_to_lidar(cam, calib)
        boxes = np.concatenate([boxes + rs.normal(0, 0.05, boxes.shape), _lidar_boxes(rs, 3)])
        preds.append({"pred_boxes": boxes.astype(np.float32),
                      "pred_scores": rs.rand(len(boxes)).astype(np.float32),
                      "pred_labels": np.array([1, 2, 1, 3, 2], np.int64)})
    out = tmp_path / "results"
    out.mkdir()
    kitti_dataset.KittiDataset.generate_prediction_dicts(
        {"calib": [calib] * 3, "image_shape": [np.array([375, 1242])] * 3, "frame_id": ids},
        preds, CLASSES, output_path=out)
    label_dir = tmp_path / "training" / "label_2"
    got = evaluate.evaluate(str(label_dir), str(out), str(split), [0, 1])
    want = j_evaluate.evaluate(str(label_dir), str(out), str(split), [0, 1])
    assert got[0] == want[0]
    assert list(got[1]) == list(want[1])
    for k, w in want[1].items():
        assert got[1][k] == w, k
    assert got[1]["Car_bev/easy_R40"] > 0
