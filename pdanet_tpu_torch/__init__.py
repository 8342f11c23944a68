"""pdanet_tpu_torch — the PyTorch / CUDA port of pdanet_tpu.

PDA-SSD inference and training on an NVIDIA Hopper GPU: the same YAML
configs and channels-last tensors as the JAX package, with its Pallas
kernels rewritten as CUDA C++ kernels for sm_90a (``csrc/``).  Every
kernel has a plain PyTorch version beside it, which CPU tensors run.
"""

__version__ = "0.1.0"

from .config import cfg_from_yaml_file  # noqa: E402,F401
