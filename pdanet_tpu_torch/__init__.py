"""pdanet_tpu_torch — the PyTorch / CUDA port of pdanet_tpu.

PDA-SSD inference, training and evaluation on an NVIDIA Hopper GPU, with
the numpy data pipelines of the KITTI and ONCE datasets: the same YAML
configs and channels-last tensors as the JAX package, with its Pallas
kernels rewritten as CUDA C++ kernels for sm_90a (``csrc/``).  Each
kernel is a ``torch.library`` custom op (``ops/``) whose CPU kernel is a
plain PyTorch version, so ``torch.export`` traces the serving path
(forward and rotated-NMS post-processing) into one saved program
(``serving.export_serving``; ``tools/export.py`` and ``tools/serve.py``).
"""

__version__ = "0.1.0"

from .config import cfg_from_yaml_file  # noqa: E402,F401
