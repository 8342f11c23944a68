"""Build, load and count the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all
started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``; no PyTorch header is included,
so the build takes seconds.  It runs at first use into
``pdanet_tpu_torch/_build/<hash of the sources and flags>/`` and is reused
while the sources stay the same.  ``build_log`` keeps each file's
``-Xptxas -v`` report (registers, shared memory, spills per kernel) of
the last build used, also kept beside the library as ``build.log``.

The build uses ``--fmad=false``: FPS, F-FPS, the ball query and the rotated IoU
must not contract products into FMAs (a contracted distance or cross
product flips ties and exact-zero predicates, and with them indices).  The
float32/float64 attention kernels ask for their FMAs explicitly with
``__fmaf_rn``; the bfloat16 attention kernels do their products on the
tensor cores (``mma.sync``), which the flag does not touch.

``launches`` counts kernel launches per kernel name.  Each wrapper adds
one where it launches its kernel and nowhere else, so a caller can clear
the counter, run a path and see which kernels it went through.  The
wrappers are the ``"cuda"`` kernels of the ``torch.library`` ops of
``ops/``, so the counter also counts the launches of a program that
``torch.export`` saved and loaded.  ``launches_by_k`` counts the rotated
self-IoU's and the NMS walk's launches once more under ``<name>_k<K>``,
the candidates a frame of the call, since one path runs them at several
K (a two-stage detector's proposal layer and final NMS), and FPS's under
``fps_n<N>``, the points a frame of the call (PointRCNN runs it on the
cloud and on its RoIs' 512-point clouds).
``launches_by_site`` counts the ball query's launches once more under
``ball_query_<site>``, the site its caller names (PV-RCNN runs it on each
feature source and in its RoI grid pool).

Each wrapper runs under :func:`on_tensor_device`: the device of its
tensors is the current device while it allocates, takes the stream and
launches, so that a process driving ``cuda:1`` (one process per GPU under
a launcher) launches there, and the kernels' ``cudaFuncSetAttribute``
calls and per-device caches act on that device.

``NAMESPACE``, the ops' namespace, is the name of the top-level package:
a second tree imported under another name (``chip_smoke.py --parent``)
registers its own ops beside these.
"""

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = (
    "fps.cu", "fps_features.cu", "ball_query.cu", "neighbor_attention.cu",
    "neighbor_attention_bwd.cu", "neighbor_attention_mma.cu",
    "neighbor_attention_bwd_mma.cu", "rotated_iou.cu", "nms.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = collections.Counter()
launches_by_k = collections.Counter()
launches_by_site = collections.Counter()
NAMESPACE = __name__.split(".")[0]

_lib = None
_lock = threading.Lock()
build_log = ""  # the compiler's output of the last build used in this process


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels of "
        "pdanet_tpu_torch cannot be built"
    )


def _digest(sources, defines):
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *sources, *defines)).encode())
    for path in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(sources=SOURCES, defines=()):
    """Compile ``sources`` (each ``-D`` of ``defines`` added) into one
    library if no build of the current sources exists.

    Returns the path of the shared library.  Raises with the compiler's
    output if ``nvcc`` fails.  The port loads the build of every source
    with no defines; other builds are for measuring (``chip_smoke.py
    --sweep``).
    """
    global build_log
    out = BUILD_ROOT / _digest(sources, defines) / "libpdanet_kernels.so"
    log_file = out.with_name("build.log")
    if out.exists():
        build_log = log_file.read_text() if log_file.exists() else ""
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        obj = out.parent / f"{Path(src).stem}.{tag}.o"
        log = obj.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-c", "-o", str(obj),
               str(CSRC / src)]
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((cmd, proc, obj, log))
    logs, failed = [], []
    for cmd, proc, obj, log in jobs:
        proc.wait()
        logs.append(log.read_text())
        log.unlink()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}")
    build_log = "".join(logs)
    objs = [str(obj) for _, _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed) + "\n" + build_log)
        tmp = out.with_name(f"{out.name}.{tag}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        log_file.write_text(build_log)
        os.replace(tmp, out)
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    return out


def _bind(lib):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "pdanet_fps": [vp, i32, i32, i32, vp, vp, vp],
        "pdanet_fps_config": [i32, vp],
        "pdanet_fps_features": [vp, i32, i32, i32, i32, vp, vp, vp],
        "pdanet_fps_features_config": [i32, i32, vp],
        "pdanet_ball_query": [vp, vp, i32, i32, i32, i32, vp, vp, vp, vp, vp],
        "pdanet_neighbor_attention": [vp, vp, vp, vp, i32, i32, i32, i32, i32, vp],
        "pdanet_neighbor_attention_bwd": [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                          i32, i32, vp],
        "pdanet_neighbor_attention_bf16": [vp, vp, vp, vp, i32, i32, i32, i32, vp],
        "pdanet_neighbor_attention_bwd_bf16": [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                               i32, vp],
        "pdanet_neighbor_attention_bf16_occupancy": [i32, i32],
        "pdanet_neighbor_attention_bwd_bf16_occupancy": [i32, i32],
        "pdanet_iou_bev_self": [vp, i32, i32, vp, vp],
        "pdanet_nms_walk": [vp, vp, i32, i32, f32, vp, vp, vp],
    }
    for name, args in sigs.items():
        if not hasattr(lib, name):  # a build of some of the sources
            continue
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def load(path):
    """The library at ``path`` (a ``build``), loaded and bound."""
    return _bind(ctypes.CDLL(str(path)))


def lib():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def on_tensor_device(wrapper):
    """Run a kernel wrapper with the device of its first tensor argument
    current (``torch.cuda.device``): the CUDA runtime launches on the
    current device, whatever the stream's device.  A tensor off CUDA goes
    to the wrapper unguarded, whose checks refuse it."""

    @functools.wraps(wrapper)
    def guarded(*args, **kwargs):
        first = next(a for a in args if isinstance(a, torch.Tensor))
        if first.device.type != "cuda":
            return wrapper(*args, **kwargs)
        with torch.cuda.device(first.device):
            return wrapper(*args, **kwargs)

    return guarded


def stream_handle(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(code, name):
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def require_cuda(name, *tensors, dtypes=(torch.float32,)):
    """Validate the tensors handed to a kernel wrapper."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
