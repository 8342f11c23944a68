"""The zoo's point augmentors in pdanet_tpu_torch against the JAX package, on
the CPU (host-side numpy): the world translation, the local translation,
rotation and scaling, the world and local frustum dropouts and the SE-SSD
pyramid augmentation of ``pointpillar_newaugs.yaml`` and
``pointpillar_pyramid_aug.yaml``, mirroring ``tests/test_augmentor.py``.

* Each augmentor through ``DataAugmentor.forward``, on LiDAR-like frames of
  five boxes with points in them: points, boxes and names bit-equal to
  JAX's from one ``np.random.seed`` (``workers=0``: numpy's global stream,
  in JAX's order), over several seeds, and changing the frame on some.
* Under a sample's own generator (``random_draws.sample_generator``, what
  the threaded loader sets): bit-equal on a rerun, equal to JAX's from the
  same seed, numpy's global stream untouched.
* The world frustum dropout drops the names and the gt-sampling mask of the
  boxes it drops: the JAX package's ``forward`` raises on such a frame,
  the port's keeps the rows aligned.
* A mini-KITTI frame through ``KittiDataset.__getitem__`` with each of the
  two yamls' full augmentor and processors: equal to JAX's under one seed.
"""

import copy
from pathlib import Path

import numpy as np
import pytest

from kitti_fixture import build_mini_kitti
from pdanet_tpu.datasets.augmentor.data_augmentor import DataAugmentor as JDataAugmentor
from pdanet_tpu.datasets.kitti import kitti_dataset as j_kitti
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.augmentor.data_augmentor import DataAugmentor
from pdanet_tpu_torch.datasets.kitti import kitti_dataset
from pdanet_tpu_torch.datasets.random_draws import sample_generator
from pdanet_tpu_torch.utils.easydict import EasyDict
from test_torch_kitti import CLASSES, _frame_objects, assert_same

REPO = Path(__file__).resolve().parent.parent
YAMLS = {name: REPO / "tools" / "cfgs" / "kitti_models" / f"{name}.yaml"
         for name in ("pointpillar_newaugs", "pointpillar_pyramid_aug")}
SEEDS = range(4)

# each augmentor as the two yamls configure it; the frustum dropouts in all
# four directions, the pyramid augmentation also with every stage likely
AUGS = {
    "random_world_translation": dict(WORLD_TRANSLATION_RANGE=[-0.2, 0.2],
                                     ALONG_AXIS_LIST=["x", "y", "z"]),
    "random_local_translation": dict(LOCAL_TRANSLATION_RANGE=[0.95, 1.05],
                                     ALONG_AXIS_LIST=["x", "y", "z"]),
    "random_local_rotation": dict(LOCAL_ROT_ANGLE=[-0.15707963267, 0.15707963267]),
    "random_local_scaling": dict(LOCAL_SCALE_RANGE=[0.95, 1.05]),
    "random_world_frustum_dropout": dict(INTENSITY_RANGE=[0, 0.2],
                                         DIRECTION=["top", "bottom", "left", "right"]),
    "random_local_frustum_dropout": dict(INTENSITY_RANGE=[0, 0.2],
                                         DIRECTION=["top", "bottom", "left", "right"]),
    "random_local_pyramid_aug": dict(DROP_PROB=0.25, SPARSIFY_PROB=0.05, SPARSIFY_MAX_NUM=50,
                                     SWAP_PROB=0.1, SWAP_MAX_NUM=50),
    "random_local_pyramid_aug_every_stage": dict(DROP_PROB=0.5, SPARSIFY_PROB=0.6,
                                                 SPARSIFY_MAX_NUM=20, SWAP_PROB=0.6,
                                                 SWAP_MAX_NUM=20),
}


def lidar_frame(seed, n_bg=3000, high_box=False):
    """Points over a 70 x 80 x 4 m field with five boxes of 300-800 points
    each (enough for a face pyramid to hold more than 50), their names and
    the gt-sampling mask (one box masked out); with ``high_box`` a sixth box
    near the top of the cloud, which a top frustum dropout drops."""
    rs = np.random.RandomState(seed)
    pts = np.concatenate([rs.uniform([0, -40, -3], [70, 40, 1], (n_bg, 3)),
                          rs.rand(n_bg, 1)], axis=1)
    boxes = np.concatenate([rs.uniform([5, -20, -1.2], [60, 20, -0.6], (5, 3)),
                            rs.uniform([0.8, 0.6, 1.4], [4.5, 2.0, 1.8], (5, 3)),
                            rs.uniform(-np.pi, np.pi, (5, 1))], axis=1)
    if high_box:
        boxes = np.concatenate([boxes, [[30.0, 5.0, 1.6, 3.9, 1.6, 1.0, 0.3]]])
    parts = [pts]
    for box in boxes:
        n = rs.randint(300, 800)
        local = rs.uniform(-0.5, 0.5, (n, 3)) * box[3:6]
        c, s = np.cos(box[6]), np.sin(box[6])
        xyz = local @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]]) + box[:3]
        parts.append(np.concatenate([xyz, rs.rand(n, 1)], axis=1))
    names = np.array(["Car", "Pedestrian", "Cyclist", "Car", "Car", "Cyclist"][:len(boxes)])
    mask = np.ones(len(boxes), bool)
    mask[1] = False
    return {"points": np.concatenate(parts).astype(np.float32),
            "gt_boxes": boxes.astype(np.float32), "gt_names": names, "gt_boxes_mask": mask}


def augmentors(name):
    """The port's and the JAX package's ``DataAugmentor`` with ``name``
    alone."""
    cfg = dict(NAME=name.replace("_every_stage", ""), **AUGS[name])
    return (DataAugmentor(".", EasyDict(DISABLE_AUG_LIST=[], AUG_CONFIG_LIST=[EasyDict(cfg)]),
                          CLASSES),
            JDataAugmentor(".", JEasyDict(DISABLE_AUG_LIST=[],
                                          AUG_CONFIG_LIST=[JEasyDict(cfg)]), CLASSES))


def _changed(frame, out):
    return (frame["points"].shape != out["points"].shape
            or not np.array_equal(frame["points"], out["points"])
            or not np.array_equal(frame["gt_boxes"][frame["gt_boxes_mask"]], out["gt_boxes"]))


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmentor_equals_jax_from_one_seed(name):
    """Points, boxes and names bit-equal to JAX's after ``forward`` from one
    ``np.random.seed`` (the same draws consumed: the next draw equal too),
    over four seeds and frames; the frame changed on at least one."""
    ours, theirs = augmentors(name)
    changed = 0
    for seed in SEEDS:
        frame = lidar_frame(10 + seed)
        outs = []
        for aug in (ours, theirs):
            np.random.seed(seed)
            out = aug.forward(copy.deepcopy(frame))
            outs.append((out, np.random.randint(1 << 30)))
        (got, got_next), (want, want_next) = outs
        assert_same(got, want)
        assert got_next == want_next
        assert len(got["gt_names"]) == len(got["gt_boxes"])
        changed += _changed(frame, got)
    assert changed > 0


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmentor_reproducible_under_sample_generator(name):
    """Under a sample's own ``RandomState`` the port draws nothing from
    numpy's global stream, a rerun from the same seed is bit-equal, and the
    result is JAX's from that seed in the global stream."""
    ours, theirs = augmentors(name)
    for seed in SEEDS:
        frame = lidar_frame(20 + seed)
        np.random.seed(1234)
        runs = []
        for _ in range(2):
            with sample_generator(np.random.RandomState(seed)):
                runs.append(ours.forward(copy.deepcopy(frame)))
        assert np.random.randint(1 << 30) == np.random.RandomState(1234).randint(1 << 30)
        assert_same(runs[0], runs[1])
        np.random.seed(seed)
        assert_same(runs[0], theirs.forward(copy.deepcopy(frame)))


def test_world_frustum_dropout_keeps_names_and_mask_aligned():
    """A frame with a box near the top of the cloud, which the top dropout
    removes: JAX's ``forward`` raises (its gt-sampling mask keeps the old
    length), the port's drops the box's name and mask with it; the boxes
    and points equal JAX's ``global_frustum_dropout`` of the same draw."""
    from pdanet_tpu.datasets.augmentor import augmentor_utils as j_aug

    cfg = EasyDict(NAME="random_world_frustum_dropout", INTENSITY_RANGE=[0.15, 0.2],
                   DIRECTION=["top"])
    ours = DataAugmentor(".", EasyDict(DISABLE_AUG_LIST=[], AUG_CONFIG_LIST=[cfg]), CLASSES)
    theirs = JDataAugmentor(".", JEasyDict(DISABLE_AUG_LIST=[], AUG_CONFIG_LIST=[
        JEasyDict(dict(cfg))]), CLASSES)
    frame = lidar_frame(3, high_box=True)
    frame["gt_boxes2d"] = np.arange(4 * len(frame["gt_boxes"]), dtype=np.float32).reshape(-1, 4)
    np.random.seed(0)
    with pytest.raises(IndexError):
        theirs.forward(copy.deepcopy(frame))
    np.random.seed(0)
    got = ours.forward(copy.deepcopy(frame))
    np.random.seed(0)
    want_boxes, want_points = j_aug.global_frustum_dropout(
        frame["gt_boxes"].copy(), frame["points"].copy(), [0.15, 0.2], "top")
    assert len(want_boxes) == len(frame["gt_boxes"]) - 1  # the high box went
    keep = frame["gt_boxes"][:, 2] < 1.0
    np.testing.assert_array_equal(got["points"], want_points)
    np.testing.assert_array_equal(got["gt_names"], frame["gt_names"][keep & frame["gt_boxes_mask"]])
    np.testing.assert_array_equal(got["gt_boxes2d"],
                                  frame["gt_boxes2d"][keep & frame["gt_boxes_mask"]])
    want = want_boxes[frame["gt_boxes_mask"][keep]].copy()
    assert len(got["gt_boxes"]) == len(got["gt_names"]) == len(want)
    np.testing.assert_array_equal(got["gt_boxes"][:, :6], want[:, :6])


@pytest.fixture(scope="module")
def two_roots(tmp_path_factory):
    """One mini-KITTI written twice, the port's infos and gt database in one
    root and the JAX package's in the other (``test_torch_kitti.py``'s)."""
    roots = []
    cfg = cfg_from_yaml_file(str(YAMLS["pointpillar_pyramid_aug"]))
    for name, create in (("port", kitti_dataset.create_kitti_infos),
                         ("jax", j_kitti.create_kitti_infos)):
        root = tmp_path_factory.mktemp(f"kitti_{name}")
        build_mini_kitti(root, num_frames=3, frame_objects=_frame_objects(3), n_bg=3000)
        (root / "ImageSets" / "val.txt").write_text("000002\n")
        dcfg = copy.deepcopy(cfg.DATA_CONFIG)
        dcfg.DATA_PATH = str(root)
        create(dcfg if name == "port" else JEasyDict(dict(dcfg)), CLASSES, root, root,
               workers=2)
        roots.append(root)
    return roots


@pytest.mark.parametrize("yaml_name", sorted(YAMLS))
def test_kitti_getitem_with_yaml_equals_jax(two_roots, yaml_name):
    """The yaml's training pipeline (gt sampling, its augmentors, the
    range mask, the shuffle, the pillar voxelizer) on the mini-KITTI's
    frames: every frame dict and the collated batch equal to JAX's under
    one seed, for three seeds."""
    root, _ = two_roots
    cfg = cfg_from_yaml_file(str(YAMLS[yaml_name]))
    dcfg = cfg.DATA_CONFIG
    dcfg.DATA_PATH = str(root)
    names = [c.NAME for c in dcfg.DATA_AUGMENTOR.AUG_CONFIG_LIST
             if c.NAME not in dcfg.DATA_AUGMENTOR.DISABLE_AUG_LIST]
    assert set(names) & set(AUGS)
    got_ds = kitti_dataset.KittiDataset(dcfg, CLASSES, training=True, root_path=root)
    want_ds = j_kitti.KittiDataset(JEasyDict(copy.deepcopy(dict(dcfg))), CLASSES,
                                   training=True, root_path=root)
    for seed in range(3):
        samples = []
        for ds in (got_ds, want_ds):
            np.random.seed(seed)
            frames = [ds[i] for i in range(len(ds))]
            samples.append((frames, ds.collate_batch(frames)))
        (frames, batch), (j_frames, j_batch) = samples
        for f, jf in zip(frames, j_frames):
            assert_same(f, jf)
        assert_same(batch, j_batch)
        assert batch["voxels"].shape[-2:] == (32, 4)
