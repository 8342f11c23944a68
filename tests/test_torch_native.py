"""The port's g++ host library (``pdanet_tpu_torch/native``) on the CPU.

* The five tests of ``tests/test_native.py`` against the port: its four
  host sites (the voxelizer, points in boxes, the gt sampler's BEV overlap
  and the evaluation's rotated overlap) on the library against their numpy
  plain versions: the voxelizer and the masks exactly equal, the overlaps
  within 1e-4 (the plain versions clip in another order).
* The port's library bit-equal to the JAX package's (``pdanet_tpu.native``,
  the same source) on the same seeded inputs, at each site and wrapper.
* Degenerate inputs: empty sets, points exactly on a face, identical and
  rotated-square boxes, a pair whose clip takes the parallel-edge branch,
  a budget of one voxel of one point.
* The build: a first build raced by two threads and by three processes
  into a fresh directory gives one whole library; a failed compile, a
  missing compiler and a failed load raise.
"""

import ctypes
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from pdanet_tpu import native as j_native
from pdanet_tpu.datasets.kitti.kitti_object_eval_python import rotate_iou as j_rotate_iou
from pdanet_tpu.datasets.processor.data_processor import DataProcessor as JDataProcessor
from pdanet_tpu.utils import box_utils as j_box_utils
from pdanet_tpu.utils import iou3d_np as j_iou3d_np
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import native
from pdanet_tpu_torch.datasets.kitti.kitti_object_eval_python import rotate_iou
from pdanet_tpu_torch.datasets.processor import data_processor
from pdanet_tpu_torch.datasets.processor.data_processor import DataProcessor
from pdanet_tpu_torch.utils import box_utils, iou3d_np
from pdanet_tpu_torch.utils.easydict import EasyDict

REPO = Path(__file__).resolve().parent.parent
PCR = np.array([0, -40, -3, 70.4, 40, 1], np.float32)
OVERLAP_TOL = 1e-4  # tests/test_native.py's


def _rand_boxes7(rng, n, span=15.0):
    return np.column_stack(
        [
            rng.uniform(-span, span, (n, 2)),
            rng.uniform(-1, 1, n),
            rng.uniform(0.5, 5, (n, 2)),
            rng.uniform(0.5, 3, n),
            rng.uniform(-np.pi, np.pi, n),
        ]
    ).astype(np.float32)


def _vox_cfg(max_pts=5, max_voxels=(2000, 40000), cls=EasyDict):
    return cls(NAME="transform_points_to_voxels", VOXEL_SIZE=[0.05, 0.05, 0.1],
               MAX_POINTS_PER_VOXEL=max_pts,
               MAX_NUMBER_OF_VOXELS={"train": max_voxels[0], "test": max_voxels[1]})


def _cloud(rng, n=30000):
    """Points over and beyond ``PCR`` (some out of range), a tenth of them
    in a 0.2 m clump that fills its voxels past their point cap."""
    pts = np.column_stack([rng.uniform(-5, 75, n), rng.uniform(-45, 45, n),
                           rng.uniform(-4, 2, n), rng.uniform(0, 1, n)])
    clump = rng.permutation(n)[:n // 10]
    pts[clump, :3] = rng.uniform([20, 5, -1], [20.2, 5.2, -0.8], (len(clump), 3))
    return pts.astype(np.float32)


def _plain_voxels(pts, cfg, training):
    dp = DataProcessor([cfg], PCR, training=training, num_point_features=4)
    max_voxels = cfg.MAX_NUMBER_OF_VOXELS["train" if training else "test"]
    return data_processor.voxelize_plain(pts, PCR, np.asarray(cfg.VOXEL_SIZE, np.float32),
                                         dp.grid_size, cfg.MAX_POINTS_PER_VOXEL, max_voxels)


def _assert_bit_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---- tests/test_native.py's five tests, against the port


def test_bev_iou_identity_regression():
    box = np.array([[1.0, -2.0, 0.0, 1.6, 3.9, 1.5, 0.7]], np.float32)
    assert np.allclose(iou3d_np.boxes_bev_iou_cpu(box, box), 1.0, atol=1e-5)


def test_rotated_overlap_native_vs_numpy():
    rng = np.random.default_rng(7)
    a, b = _rand_boxes7(rng, 60), _rand_boxes7(rng, 45)
    got = iou3d_np.boxes_bev_overlap_cpu(a, b)
    want = iou3d_np.boxes_bev_overlap_plain(a, b)
    assert got.dtype == want.dtype == np.float32 and got.shape == (60, 45)
    assert (got > 0).sum() > 10  # pairs that meet
    np.testing.assert_allclose(got, want, rtol=0, atol=OVERLAP_TOL)


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_eval_rotate_iou_native_vs_numpy(monkeypatch, criterion):
    rng = np.random.default_rng(11)
    a = _rand_boxes7(rng, 50)[:, [0, 1, 3, 4, 6]].astype(np.float64)
    b = _rand_boxes7(rng, 40)[:, [0, 1, 3, 4, 6]].astype(np.float64)
    got = rotate_iou.rotate_iou_eval(a, b, criterion)
    monkeypatch.setattr(rotate_iou, "rotate_overlap", rotate_iou.rotate_overlap_plain)
    want = rotate_iou.rotate_iou_eval(a, b, criterion)
    assert got.dtype == want.dtype and got.shape == (50, 40)
    assert (got > 0).sum() > 10
    np.testing.assert_allclose(got, want, rtol=0, atol=OVERLAP_TOL)


def test_points_in_boxes_native_vs_numpy():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-15, 15, (4000, 3)).astype(np.float32)
    boxes = _rand_boxes7(rng, 30)
    got = box_utils.points_in_boxes_cpu(pts, boxes)
    assert got.sum() > 50
    _assert_bit_equal(got, box_utils.points_in_boxes_plain(pts, boxes))


@pytest.mark.parametrize("training", [True, False], ids=["train_2000", "test_40000"])
def test_voxelizer_native_vs_numpy(training):
    pts = _cloud(np.random.default_rng(5))  # overflows the 2000-voxel budget
    cfg = _vox_cfg()
    dp = DataProcessor([cfg], PCR, training=training, num_point_features=4)
    got = dp.forward({"points": pts.copy(), "use_lead_xyz": True})
    want = _plain_voxels(pts, cfg, training)
    for key, w in zip(("voxels", "voxel_coords", "voxel_num_points"), want):
        _assert_bit_equal(got[key], w)
    # both caps reached: the split's voxel budget (train) and 5 points a voxel
    assert got["max_number_of_voxels"] == (2000 if training else 40000)
    assert len(got["voxels"]) == 2000 if training else 2000 < len(got["voxels"]) < 40000
    assert got["voxel_num_points"].max() == 5


# ---- the port's library bit-equal to the JAX package's


def _site_inputs(rng):
    a, b = _rand_boxes7(rng, 50), _rand_boxes7(rng, 35)
    pts = rng.uniform(-15, 15, (6000, 4)).astype(np.float32)
    return a, b, pts


SITES = {
    "voxelizer": (
        lambda pts, a, b: DataProcessor([_vox_cfg()], PCR, True, 4).forward(
            {"points": _cloud_of(pts)}),
        lambda pts, a, b: JDataProcessor([_vox_cfg(cls=JEasyDict)], PCR, True, 4).forward(
            {"points": _cloud_of(pts)})),
    "points_in_boxes_cpu": (lambda pts, a, b: box_utils.points_in_boxes_cpu(pts[:, :3], a),
                            lambda pts, a, b: j_box_utils.points_in_boxes_cpu(pts[:, :3], a)),
    "boxes_bev_overlap_cpu": (lambda pts, a, b: iou3d_np.boxes_bev_iou_cpu(a, b),
                              lambda pts, a, b: j_iou3d_np.boxes_bev_iou_cpu(a, b)),
    "rotate_iou_eval": (
        lambda pts, a, b: [rotate_iou.rotate_iou_eval(
            a[:, [0, 1, 3, 4, 6]].astype(np.float64), b[:, [0, 1, 3, 4, 6]], c)
            for c in (-1, 0, 1, 2)],
        lambda pts, a, b: [j_rotate_iou.rotate_iou_eval(
            a[:, [0, 1, 3, 4, 6]].astype(np.float64), b[:, [0, 1, 3, 4, 6]], c)
            for c in (-1, 0, 1, 2)]),
}


def _cloud_of(pts):
    """The seeded points spread over ``PCR`` (a fresh copy per call)."""
    return (pts * np.array([2.5, 2.5, 0.2, 1.0], np.float32)
            + np.array([35.0, 0.0, -1.0, 0.0], np.float32))


def _flat(out):
    if isinstance(out, dict):
        return [out[k] for k in ("voxels", "voxel_coords", "voxel_num_points")]
    return out if isinstance(out, list) else [out]


@pytest.fixture(scope="module")
def jax_library():
    assert j_native.NATIVE_AVAILABLE, "the JAX package's host library did not build"
    return j_native


@pytest.mark.parametrize("site", list(SITES))
def test_site_bit_equal_to_jax_library(jax_library, site):
    a, b, pts = _site_inputs(np.random.default_rng(17))
    port_fn, jax_fn = SITES[site]
    got, want = _flat(port_fn(pts, a, b)), _flat(jax_fn(pts, a, b))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_bit_equal(g, w)
    assert any(np.count_nonzero(g) for g in got)


@pytest.mark.parametrize("wrapper", ["rotated_overlap", "points_in_boxes", "voxelize"])
def test_wrapper_bit_equal_to_jax_library(jax_library, wrapper):
    rng = np.random.default_rng(23)
    if wrapper == "rotated_overlap":
        args = (_rand_boxes7(rng, 40)[:, [0, 1, 3, 4, 6]].astype(np.float64),
                _rand_boxes7(rng, 30)[:, [0, 1, 3, 4, 6]].astype(np.float64))
    elif wrapper == "points_in_boxes":
        args = (rng.uniform(-15, 15, (5000, 4)).astype(np.float32), _rand_boxes7(rng, 25))
    else:
        grid = np.array([1408, 1600, 40], np.int64)
        args = (_cloud(rng), PCR, np.array([0.05, 0.05, 0.1], np.float32), grid, 5, 3000)
    got, want = getattr(native, wrapper)(*args), getattr(j_native, wrapper)(*args)
    for g, w in zip(_flat(list(got) if isinstance(got, tuple) else got),
                    _flat(list(want) if isinstance(want, tuple) else want)):
        _assert_bit_equal(g, w)


# ---- degenerate inputs


EMPTY = {
    "points_in_boxes_cpu": [
        (np.zeros((0, 3), np.float32), _rand_boxes7(np.random.default_rng(0), 4)),
        (np.ones((5, 3), np.float32), np.zeros((0, 7), np.float32))],
    "boxes_bev_overlap_cpu": [
        (np.zeros((0, 7), np.float32), _rand_boxes7(np.random.default_rng(0), 3)),
        (_rand_boxes7(np.random.default_rng(0), 3), np.zeros((0, 7), np.float32))],
    "rotate_overlap": [(np.zeros((0, 5)), np.ones((2, 5))), (np.ones((2, 5)), np.zeros((0, 5)))],
    "voxelizer": [(np.zeros((0, 4), np.float32), None),
                  (np.array([[-50.0, 0, 0, 1]], np.float32), None)],  # all out of range
}


@pytest.mark.parametrize("site", list(EMPTY))
def test_empty_inputs_equal_jax_and_plain(jax_library, site):
    for x, y in EMPTY[site]:
        if site == "points_in_boxes_cpu":
            outs = [f(x, y) for f in (box_utils.points_in_boxes_cpu,
                                      box_utils.points_in_boxes_plain,
                                      j_box_utils.points_in_boxes_cpu)]
            assert outs[0].shape == (len(y), len(x))
        elif site == "boxes_bev_overlap_cpu":
            outs = [f(x, y) for f in (iou3d_np.boxes_bev_overlap_cpu,
                                      iou3d_np.boxes_bev_overlap_plain,
                                      j_iou3d_np.boxes_bev_overlap_cpu)]
            assert outs[0].shape == (len(x), len(y))
        elif site == "rotate_overlap":
            outs = [f(x, y) for f in (rotate_iou.rotate_overlap, rotate_iou.rotate_overlap_plain,
                                      j_rotate_iou.rotate_overlap)]
            assert outs[0].shape == (len(x), len(y))
        else:
            cfg = _vox_cfg()
            got = DataProcessor([cfg], PCR, True, 4).forward({"points": x})
            want = JDataProcessor([_vox_cfg(cls=JEasyDict)], PCR, True, 4).forward(
                {"points": x.copy()})
            outs = [_flat(got), list(_plain_voxels(x, cfg, True)), _flat(want)]
            assert outs[0][0].shape == (0, 5, 4) and outs[0][1].shape == (0, 3)
            for other in outs[1:]:
                for g, w in zip(outs[0], other):
                    _assert_bit_equal(g, w)
            continue
        for other in outs[1:]:
            _assert_bit_equal(outs[0], other)


def test_points_exactly_on_faces():
    # heading 0 (cos 1, sin 0 exactly): x / y faces are strict with a 1e-5
    # slack, z faces inclusive
    box = np.array([[0.0, 0.0, 0.0, 2.0, 4.0, 2.0, 0.0]], np.float32)
    hx = np.float32(1.0) + np.float32(1e-5)
    hy = np.float32(2.0) + np.float32(1e-5)
    pts = np.array([
        [1.0, 0, 0], [-1.0, 0, 0], [0, 2.0, 0], [0, -2.0, 0],  # on the box's x / y faces
        [0, 0, 1.0], [0, 0, -1.0],                            # on its z faces
        [hx, 0, 0], [-hx, 0, 0], [0, hy, 0], [0, -hy, 0],     # on the slack's faces
        [0, 0, np.nextafter(np.float32(1), np.float32(2))],   # an ulp above the top
        [np.nextafter(hx, np.float32(0)), 0, 0],              # an ulp inside the slack
    ], np.float32)
    want = np.array([[1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 1]], np.int32)
    got = box_utils.points_in_boxes_cpu(pts, box)
    _assert_bit_equal(got, want)
    _assert_bit_equal(box_utils.points_in_boxes_plain(pts, box), want)
    _assert_bit_equal(j_box_utils.points_in_boxes_cpu(pts, box), want)


PARALLEL = {  # (a, b, area): every edge of b parallel to an edge of a
    "identical": ([3.0, -2.0, 0.0, 4.0, 1.8, 1.5, 0.7], [3.0, -2.0, 0.0, 4.0, 1.8, 1.5, 0.7],
                  4.0 * 1.8),
    "square_quarter_turn": ([0.0, 0.0, 0.0, 2.0, 2.0, 1.0, 0.0],
                            [0.0, 0.0, 0.0, 2.0, 2.0, 1.0, np.pi / 2], 4.0),
    "square_half_turn_shifted": ([0.0, 0.0, 0.0, 2.0, 2.0, 1.0, 0.3],
                                 [0.5, 0.0, 0.0, 2.0, 2.0, 1.0, 0.3 + np.pi], None),
    "shared_edge": ([0.0, 0.0, 0.0, 2.0, 2.0, 1.0, 0.0], [2.0, 0.0, 0.0, 2.0, 2.0, 1.0, 0.0],
                    0.0),
}


@pytest.mark.parametrize("case", list(PARALLEL))
def test_parallel_edges(jax_library, case):
    a, b, area = PARALLEL[case]
    a, b = np.array([a], np.float32), np.array([b], np.float32)
    got = iou3d_np.boxes_bev_overlap_cpu(a, b)
    np.testing.assert_allclose(got, iou3d_np.boxes_bev_overlap_plain(a, b), rtol=0,
                               atol=OVERLAP_TOL)
    _assert_bit_equal(got, j_iou3d_np.boxes_bev_overlap_cpu(a, b))
    a5 = a[:, [0, 1, 3, 4, 6]].astype(np.float64)
    b5 = b[:, [0, 1, 3, 4, 6]].astype(np.float64)
    ev = rotate_iou.rotate_overlap(a5, b5)
    np.testing.assert_allclose(ev, rotate_iou.rotate_overlap_plain(a5, b5), rtol=0,
                               atol=OVERLAP_TOL)
    _assert_bit_equal(ev, j_rotate_iou.rotate_overlap(a5, b5))
    if area is not None:
        np.testing.assert_allclose(got, [[area]], rtol=1e-6, atol=1e-6)


def test_parallel_edge_branch(jax_library):
    """The clip's parallel branch (``pdanet_host.cc`` ``clip_edge``): A is
    B turned by 1.75e-13 rad and raised by 5.75e-13 m, so its top corners
    lie 7.5e-13 and 4e-13 m above B's top edge.  The top edge's clip then
    meets a segment that crosses the tolerance band with a denominator
    below 1e-12, and keeps its end point as the numpy clip does.  (The
    vectorized 24-candidate ``rotate_overlap_plain`` drops a corner here
    and reads 3.0: a property of the JAX package's numpy path, ROADMAP
    queue 3; it is not compared.)"""
    a = np.array([[0.0, 5.75e-13, 0.0, 2.0, 2.0, 1.0, 1.75e-13]])
    b = np.array([[0.0, 0.0, 0.0, 2.0, 2.0, 1.0, 0.0]])
    got = iou3d_np.boxes_bev_overlap_cpu(a, b)
    _assert_bit_equal(got, j_iou3d_np.boxes_bev_overlap_cpu(a, b))
    _assert_bit_equal(got, iou3d_np.boxes_bev_overlap_plain(a, b))
    np.testing.assert_allclose(got, [[4.0]], rtol=1e-6)
    a5, b5 = a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]]
    _assert_bit_equal(native.rotated_overlap(a5, b5), j_native.rotated_overlap(a5, b5))


def test_budget_of_one_voxel_of_one_point(jax_library):
    pts = _cloud(np.random.default_rng(9), 500)
    cfg = _vox_cfg(max_pts=1, max_voxels=(1, 1))
    got = DataProcessor([cfg], PCR, True, 4).forward({"points": pts.copy()})
    want = JDataProcessor([_vox_cfg(1, (1, 1), JEasyDict)], PCR, True, 4).forward(
        {"points": pts.copy()})
    plain = _plain_voxels(pts, cfg, True)
    for g, w, p in zip(_flat(got), _flat(want), plain):
        _assert_bit_equal(g, w)
        _assert_bit_equal(g, p)
    assert got["voxels"].shape == (1, 1, 4) and got["voxel_num_points"][0] == 1
    first = pts[(pts[:, :3] >= PCR[:3]).all(1) & (pts[:, :3] < PCR[3:]).all(1)][0]
    _assert_bit_equal(got["voxels"][0, 0], first)


# ---- the build


def _fresh_build(monkeypatch, root):
    monkeypatch.setattr(native, "BUILD_ROOT", root)
    monkeypatch.setattr(native, "_lib", None)


def test_first_build_raced_by_two_threads(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    compiles, run = [], subprocess.run

    def counted_run(cmd, **kw):
        compiles.append(cmd[0])
        return run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", counted_run)
    start, libs, errors = threading.Barrier(2), [], []

    def first_use():
        start.wait(timeout=30)
        try:
            libs.append(native.lib())
        except RuntimeError as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors and len(libs) == 2 and libs[0] is libs[1]
    assert compiles == [native.CXX]
    # ctypes.CDLL (not PyDLL): each call releases the interpreter lock
    assert type(libs[0]) is ctypes.CDLL
    built = sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*") if p.is_file())
    assert len(built) == 1 and built[0].startswith("host_") and built[0].endswith(
        "/libpdanet_host.so"), built
    a = np.array([[0.0, 0.0, 2.0, 2.0, 0.0]])
    np.testing.assert_allclose(native.rotated_overlap(a, a), [[4.0]])


def test_first_build_raced_by_three_processes(tmp_path):
    code = ("import sys, numpy as np\n"
            "from pathlib import Path\n"
            "from pdanet_tpu_torch import native\n"
            "native.BUILD_ROOT = Path(sys.argv[1])\n"
            "a = np.array([[0.0, 0.0, 2.0, 2.0, 0.0]])\n"
            "print(native.rotated_overlap(a, a)[0, 0])\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert float(out) == 4.0
    built = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert [p.name for p in built] == ["libpdanet_host.so"], built


@pytest.mark.parametrize("compiler", ["false", "no-such-compiler-of-pdanet"])
def test_failed_build_raises(monkeypatch, tmp_path, compiler):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(native, "CXX", compiler)
    with pytest.raises(RuntimeError, match=compiler):
        native.lib()
    with pytest.raises(RuntimeError):  # every site, no fallback
        box_utils.points_in_boxes_cpu(np.zeros((3, 3), np.float32),
                                      _rand_boxes7(np.random.default_rng(0), 2))
    assert native._lib is None
    assert not [p for p in tmp_path.rglob("*") if p.is_file()]  # no partial library left


def test_failed_load_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    bad = tmp_path / "libpdanet_host.so"
    bad.write_bytes(b"not a shared library")
    monkeypatch.setattr(native, "build", lambda: bad)
    with pytest.raises(RuntimeError, match="cannot be loaded"):
        native.lib()
