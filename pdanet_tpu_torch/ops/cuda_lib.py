"""Build, load and count the hand-written Hopper kernels in ``csrc/``.

The ``csrc/*.cu`` files compile with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``; no PyTorch header is
included, so the build takes seconds.  It runs at first use into
``pdanet_tpu_torch/_build/<hash of the sources and flags>/`` and is reused
while the sources stay the same.

The build uses ``--fmad=false``: FPS, the ball query and the rotated IoU
must not contract products into FMAs (a contracted distance or cross
product flips ties and exact-zero predicates, and with them indices).  The
attention kernels ask for their FMAs explicitly with ``__fmaf_rn``.

``launches`` counts kernel launches per kernel name.  Each wrapper adds
one where it launches its kernel and nowhere else, so a caller can clear
the counter, run a path and see which kernels it went through.
"""

import collections
import ctypes
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
    "fps.cu", "ball_query.cu", "neighbor_attention.cu",
    "neighbor_attention_bwd.cu", "rotated_iou.cu", "nms.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = collections.Counter()

_lib = None
_lock = threading.Lock()
build_log = ""  # the compiler's output of the last build in this process


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


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if no build of the current sources exists.

    Returns the path of the shared library.  Raises with the compiler's
    output if ``nvcc`` fails.
    """
    global build_log
    out = BUILD_ROOT / _digest() / "libpdanet_kernels.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}): {' '.join(cmd)}\n{build_log}"
        )
    os.replace(tmp, out)
    return out


def _bind(lib):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "pdanet_fps": [vp, i32, i32, i32, vp, vp, vp],
        "pdanet_ball_query": [vp, vp, i32, i32, i32, i32, vp, vp, vp, vp],
        "pdanet_neighbor_attention": [vp, vp, vp, vp, i32, i32, i32, i32, i32, vp],
        "pdanet_neighbor_attention_bwd": [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                          i32, i32, vp],
        "pdanet_iou_bev_self": [vp, i32, i32, vp, vp],
        "pdanet_nms_walk": [vp, vp, i32, i32, f32, vp, vp],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def lib():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


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
