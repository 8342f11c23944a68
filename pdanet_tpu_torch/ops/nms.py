"""Greedy NMS keep mask over score-sorted candidates, and the one-frame
score-sorted rotated NMS built on it.

Counterpart of ``pdanet_tpu/ops/nms.py:25-124``: keep[i] = valid[i] and no
earlier kept candidate j has IoU[j, i] > thresh.  The op ``<package>::nms``
runs the kernels in ``csrc/nms.cu`` (K up to ``NMS_MAX_K``) for a CUDA
tensor and :func:`greedy_nms_mask_batched_plain` for a CPU tensor.
"""

import ctypes

import numpy as np
import torch

from . import cuda_lib
from .rotated_iou import boxes_iou_bev_batched_self

NMS_MAX_K = 10240  # kMaxK in csrc/nms.cu: 160 removed words, five a lane of one warp
# (two a lane up to K 4096)


def greedy_nms_mask_batched(iou, valid, thresh):
    """(B, K, K) float32 IoU x (B, K) bool -> (B, K) bool keep."""
    return nms_op(iou, valid, float(thresh))


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


@cuda_lib.on_tensor_device
def greedy_nms_mask_batched_cuda(iou, valid, thresh):
    """The kernels: one warp per (frame, row) turns the IoU into 64-bit
    suppression words in a (B, K, ceil(K / 64)) workspace, then one warp
    per frame walks the candidates 64 at a time.  One launch count a call.
    Raises beyond ``NMS_MAX_K`` candidates a frame."""
    if iou.dim() != 3 or iou.shape[1] != iou.shape[2] \
            or tuple(valid.shape) != tuple(iou.shape[:2]):
        raise ValueError(
            f"greedy_nms_mask_batched: want (B, K, K) and (B, K), got "
            f"{tuple(iou.shape)} and {tuple(valid.shape)}")
    B, K, _ = iou.shape
    if K > NMS_MAX_K:
        raise ValueError(f"greedy_nms_mask_batched: K {K} > {NMS_MAX_K} candidates a frame")
    cuda_lib.require_cuda("greedy_nms_mask_batched", iou)
    cuda_lib.require_cuda("greedy_nms_mask_batched", valid, dtypes=(torch.bool,))
    if valid.device != iou.device:
        raise ValueError("greedy_nms_mask_batched: iou and valid on different devices")
    keep = torch.empty((B, K), dtype=torch.bool, device=iou.device)
    mask = torch.empty((B, K, -(-K // 64)), dtype=torch.int64, device=iou.device)
    lib = cuda_lib.lib()
    code = lib.pdanet_nms_walk(
        cuda_lib.ptr(iou), cuda_lib.ptr(valid), B, K,
        ctypes.c_float(float(np.float32(thresh))), cuda_lib.ptr(mask), cuda_lib.ptr(keep),
        cuda_lib.stream_handle(iou.device))
    cuda_lib.check(code, "nms")
    cuda_lib.launches["nms"] += 1
    cuda_lib.launches_by_k[f"nms_k{K}"] += 1
    return keep


@torch.library.custom_op(f"{cuda_lib.NAMESPACE}::nms", mutates_args=(), device_types="cpu")
def nms_op(iou: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    return greedy_nms_mask_batched_plain(iou, valid, thresh)


nms_op.register_kernel("cuda")(greedy_nms_mask_batched_cuda)


@nms_op.register_fake
def _(iou, valid, thresh):
    return valid.new_empty(valid.shape, dtype=torch.bool)


def nms_rotated(boxes, scores, thresh, pre_maxsize=None, post_maxsize=None,
                score_thresh=None):
    """Score-sorted rotated NMS of one frame with fixed-size outputs (JAX
    ``nms.py:84-124``, ``class_agnostic_nms`` fused with ``nms_gpu``): score
    threshold, the ``pre_maxsize`` best in a stable order, the rotated BEV
    self-IoU and the greedy walk as one-frame calls of the IoU and NMS ops
    (their kernels on a CUDA tensor), the first ``post_maxsize`` kept.

    boxes (N, 7+), scores (N,) -> (selected (post,) int32 indices into the
    input, -1 padded; count () int32; their scores, 0 padded)."""
    N = boxes.shape[0]
    pre = min(pre_maxsize or N, N)
    post = min(post_maxsize or pre, pre)
    valid = torch.isfinite(scores)
    if score_thresh is not None:
        valid = valid & (scores >= score_thresh)
    masked = torch.where(valid, scores, -torch.inf)
    # stable descending order: equal scores keep the lower index first
    order = torch.sort(masked, descending=True, stable=True).indices[:pre]
    cand_boxes = boxes[order][:, :7].to(torch.float32).contiguous()
    iou = boxes_iou_bev_batched_self(cand_boxes[None])
    keep = greedy_nms_mask_batched(iou, valid[order][None].contiguous(), thresh)[0]
    rank = torch.cumsum(keep.to(torch.int64), dim=0) - 1
    src = torch.where(keep & (rank < post), rank, post)
    sel = torch.full((post + 1,), -1, dtype=torch.int64, device=boxes.device)
    sel.scatter_(0, src, order)  # slot `post` collects what is dropped
    sel = sel[:post]
    count = torch.clamp(keep.sum(), max=post).to(torch.int32)
    sel_scores = torch.where(sel >= 0, scores[sel.clamp(min=0)], 0.0)
    return sel.to(torch.int32), count, sel_scores
