"""The host library of the port: the rotated BEV overlap, points in boxes
and the grid-hash voxelizer in C++ (``src/pdanet_host.cc``), bound with
``ctypes``.

It is the port's copy of the JAX package's ``pdanet_tpu/native``: the same
source and flags, so both packages' default host paths give the same bits.
It serves four host sites, each of which keeps its numpy plain version
beside it for the tests and ``chip_smoke.py``:

* ``datasets/processor/data_processor.py`` ``transform_points_to_voxels``
  (every voxel detector, every frame) through :func:`voxelize`;
* ``utils/box_utils.py`` ``points_in_boxes_cpu`` (the gt database, the
  infos' point counts, the gt sampler) through :func:`points_in_boxes`;
* ``utils/iou3d_np.py`` ``boxes_bev_overlap_cpu`` (the gt sampler's
  collision test) and ``datasets/kitti/kitti_object_eval_python/
  rotate_iou.py`` ``rotate_overlap`` (the KITTI and ONCE evaluations)
  through :func:`rotated_overlap`.

g++ compiles the source at first use into
``pdanet_tpu_torch/_build/host_<hash of the source and flags>/``, where
later processes find it.  ``-ffp-contract=off`` keeps products apart from
sums on every host (GCC contracts them into FMAs by default where the
target has FMA, as aarch64 does), so the masks equal the plain versions'.
A missing compiler, a failed compile or a failed load raises
``RuntimeError``; there is no fallback.  ``ctypes.CDLL`` releases the
interpreter lock during each call, so the loader's threads run the library
in parallel.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "pdanet_host.cc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fno-math-errno", "-ffp-contract=off")

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")

_lib = None
_lock = threading.Lock()


def build():
    """Compile ``SRC`` unless a build of this source with these flags
    exists; returns the shared library's path.

    The compiler writes a file of this process's own and ``os.replace``
    moves it into place, so processes that build at once (pytest's
    workers, a launcher's ranks) each find a whole library."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_ROOT / f"host_{digest}" / "libpdanet_host.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}: the host library of pdanet_tpu_torch "
                           f"cannot be built") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib):
    lib.rotated_overlap_f64.restype = None
    lib.rotated_overlap_f64.argtypes = [_f64p, _i64, _f64p, _i64, _f64p]
    lib.points_in_boxes_f32.restype = None
    lib.points_in_boxes_f32.argtypes = [_f32p, _i64, _f32p, _i64, _i32p]
    lib.voxelize_f32.restype = _i64
    lib.voxelize_f32.argtypes = [_f32p, _i64, _i64, _f32p, _f32p, _i64p, _i64, _i64, _f32p,
                                 _i32p, _i32p]
    return lib


def lib():
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except OSError as e:
                raise RuntimeError(f"the host library {path} cannot be loaded: {e}") from e
        return _lib


def _rows(x, dtype, width, name):
    arr = np.ascontiguousarray(x, dtype=dtype)
    if arr.ndim != 2 or arr.shape[1] != width:
        raise ValueError(f"{name}: want (n, {width}), got {arr.shape}")
    return arr


def _points(x):
    arr = np.asarray(x)
    if arr.ndim != 2 or arr.shape[1] < 3:
        raise ValueError(f"points: want (n, 3) or wider, got {arr.shape}")
    return arr


def rotated_overlap(boxes_a, boxes_b):
    """(N, 5) x (K, 5) ``(cx, cy, w, h, angle)`` -> (N, K) float64
    intersection areas."""
    a = _rows(boxes_a, np.float64, 5, "boxes_a")
    b = _rows(boxes_b, np.float64, 5, "boxes_b")
    n, k = len(a), len(b)
    out = np.zeros((n, k), dtype=np.float64)
    fn = lib().rotated_overlap_f64
    if n and k:
        fn(a, n, b, k, out)
    return out


def points_in_boxes(points, boxes):
    """(N, >= 3) points x (M, 7) boxes ``(x, y, z, dx, dy, dz, heading)`` ->
    (M, N) int32 0/1 mask."""
    p = np.ascontiguousarray(_points(points)[:, 0:3], dtype=np.float32)
    b = _rows(boxes, np.float32, 7, "boxes")
    n, m = len(p), len(b)
    out = np.zeros((m, n), dtype=np.int32)
    fn = lib().points_in_boxes_f32
    if n and m:
        fn(p, n, b, m, out)
    return out


def voxelize(points, point_cloud_range, voxel_size, grid_size, max_pts, max_voxels):
    """Grid-hash voxelization of (N, C) points: voxels in the order of their
    first point, points in scan order within a voxel, at most ``max_pts`` a
    voxel and ``max_voxels`` voxels.  Returns ``(voxels (V, max_pts, C)
    float32, coords (V, 3) int32 zyx, num_points (V,) int32)`` of exactly
    the V voxels written, unused point slots zero."""
    p = np.ascontiguousarray(_points(points), dtype=np.float32)
    pcr = np.ascontiguousarray(point_cloud_range, dtype=np.float32)
    vsz = np.ascontiguousarray(voxel_size, dtype=np.float32)
    grid = np.ascontiguousarray(grid_size, dtype=np.int64)
    if pcr.shape != (6,) or vsz.shape != (3,) or grid.shape != (3,):
        raise ValueError(f"range {pcr.shape}, voxel size {vsz.shape}, grid {grid.shape}: "
                         f"want (6,), (3,), (3,)")
    n, c = p.shape
    max_pts, max_voxels = int(max_pts), int(max_voxels)
    voxels = np.zeros((max_voxels, max_pts, c), dtype=np.float32)
    coords = np.zeros((max_voxels, 3), dtype=np.int32)
    num_points = np.zeros((max_voxels,), dtype=np.int32)
    nv = lib().voxelize_f32(p, n, c, pcr, vsz, grid, max_pts, max_voxels, voxels, coords,
                            num_points)
    # trim each buffer to its first nv rows in place (a realloc, no copy):
    # the budget's unused tail is freed at once, not kept alive by views
    # through the collate
    for arr, shape in ((voxels, (nv, max_pts, c)), (coords, (nv, 3)), (num_points, (nv,))):
        arr.resize(shape, refcheck=False)
    return voxels, coords, num_points
