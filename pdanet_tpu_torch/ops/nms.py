"""Greedy NMS keep mask over score-sorted candidates.

Counterpart of ``pdanet_tpu/ops/nms.py:25-81``: keep[i] = valid[i] and no
earlier kept candidate j has IoU[j, i] > thresh.  A CUDA tensor runs the
kernel in ``csrc/nms.cu``; a CPU tensor runs
:func:`greedy_nms_mask_batched_plain`.
"""

import ctypes

import numpy as np
import torch

from . import cuda_lib


def greedy_nms_mask_batched(iou, valid, thresh):
    """(B, K, K) float32 IoU x (B, K) bool -> (B, K) bool keep."""
    if iou.device.type == "cpu":
        return greedy_nms_mask_batched_plain(iou, valid, thresh)
    return greedy_nms_mask_batched_cuda(iou, valid, thresh)


def greedy_nms_mask_batched_plain(iou, valid, thresh):
    """The plain PyTorch version: the walk in running-suppression form."""
    B, K, _ = iou.shape
    suppress = iou > float(np.float32(thresh))
    keep = torch.zeros((B, K), dtype=torch.bool, device=iou.device)
    sup = torch.zeros((B, K), dtype=torch.bool, device=iou.device)
    for i in range(K):
        keep[:, i] = valid[:, i] & ~sup[:, i]
        sup |= keep[:, i:i + 1] & suppress[:, i]
    return keep


def greedy_nms_mask_batched_cuda(iou, valid, thresh):
    """The kernel: one CTA per frame walks the candidates."""
    if iou.dim() != 3 or iou.shape[1] != iou.shape[2] \
            or tuple(valid.shape) != tuple(iou.shape[:2]):
        raise ValueError(
            f"greedy_nms_mask_batched: want (B, K, K) and (B, K), got "
            f"{tuple(iou.shape)} and {tuple(valid.shape)}")
    cuda_lib.require_cuda("greedy_nms_mask_batched", iou)
    cuda_lib.require_cuda("greedy_nms_mask_batched", valid, dtypes=(torch.bool,))
    if valid.device != iou.device:
        raise ValueError("greedy_nms_mask_batched: iou and valid on different devices")
    B, K, _ = iou.shape
    keep = torch.empty((B, K), dtype=torch.bool, device=iou.device)
    lib = cuda_lib.lib()
    code = lib.pdanet_nms_walk(
        cuda_lib.ptr(iou), cuda_lib.ptr(valid), B, K,
        ctypes.c_float(float(np.float32(thresh))), cuda_lib.ptr(keep),
        cuda_lib.stream_handle(iou.device))
    cuda_lib.check(code, "nms")
    cuda_lib.launches["nms"] += 1
    return keep
