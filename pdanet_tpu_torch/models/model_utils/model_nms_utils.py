"""Post-processing NMS over fixed-size candidates: counterpart of
``pdanet_tpu/models/model_utils/model_nms_utils.py:18-153``
(``class_agnostic_nms``, one frame's NMS by the yaml's ``NMS_CONFIG``;
``batched_nms_candidates``, the one copy every ported detector's
post-processing and the two-stage proposal layer call, and
``batched_multi_classes_nms``, one such NMS a class).

The candidates a frame are the ``NMS_PRE_MAXSIZE`` best by score in a
stable order; their rotated BEV self-IoU and the greedy walk run as one
batched call each (the kernels of ``ops/rotated_iou.py`` and
``ops/nms.py`` on a CUDA tensor), and the kept candidates are compacted,
in score order, into ``NMS_POST_MAXSIZE`` slots.
"""

import torch

from ...ops.nms import greedy_nms_mask_batched, nms_rotated
from ...ops.rotated_iou import boxes_iou_bev_batched_self
from ...utils.easydict import EasyDict


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None):
    """One frame: box_scores (N,) sigmoid scores, box_preds (N, 7) ->
    (selected (POST,) int32 indices, -1 padded; count; their scores), by
    ``ops.nms.nms_rotated`` with the config's threshold and sizes."""
    return nms_rotated(box_preds, box_scores, thresh=float(nms_config.NMS_THRESH),
                       pre_maxsize=int(nms_config.NMS_PRE_MAXSIZE),
                       post_maxsize=int(nms_config.NMS_POST_MAXSIZE),
                       score_thresh=score_thresh)


def batched_nms_candidates(boxes, scores, labels, valid, nms_cfg, score_thresh=None):
    """Batched class-agnostic rotated NMS.

    boxes (B, N, 7+), scores (B, N), labels (B, N) int, valid (B, N) bool
    (a pre-filter) -> ``pred_boxes`` (B, POST, 7+), ``pred_scores`` (B,
    POST), ``pred_labels`` (B, POST) int32 and ``pred_counts`` (B,) int32,
    zero past each frame's count.  A candidate takes part where it is
    valid, its score finite and, with ``score_thresh``, at least that."""
    B, N = scores.shape
    pre = min(int(nms_cfg.NMS_PRE_MAXSIZE), N)
    post = min(int(nms_cfg.NMS_POST_MAXSIZE), pre)
    C = boxes.shape[-1]
    ok = valid & torch.isfinite(scores)
    if score_thresh is not None:
        ok = ok & (scores >= score_thresh)
    masked = torch.where(ok, scores, -torch.inf)
    # stable descending order: equal scores keep the lower index first
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, :pre]
    cand_valid = torch.gather(ok, 1, order)
    # the IoU is float32 whatever the model's dtype, as the JAX package's
    cand_boxes = torch.gather(boxes[..., :7], 1, order[..., None].expand(B, pre, 7)).to(
        torch.float32).contiguous()
    iou = boxes_iou_bev_batched_self(cand_boxes)
    keep = greedy_nms_mask_batched(iou, cand_valid.contiguous(), float(nms_cfg.NMS_THRESH))

    # stable compaction of the kept candidates (already in score order)
    rank = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    src = torch.where(keep & (rank < post), rank, post)
    sel = torch.full((B, post + 1), -1, dtype=torch.int64, device=order.device)
    sel.scatter_(1, src, order)  # slot `post` collects what is dropped
    sel = sel[:, :post]
    counts = torch.clamp(keep.sum(dim=-1), max=post).to(torch.int32)
    hit = sel >= 0
    safe = sel.clamp(min=0)
    out_boxes = torch.gather(boxes, 1, safe[..., None].expand(B, post, C))
    return {
        "pred_boxes": torch.where(hit[..., None], out_boxes, 0.0),
        "pred_scores": torch.where(hit, torch.gather(scores, 1, safe), 0.0),
        "pred_labels": torch.where(hit, torch.gather(labels, 1, safe), 0).to(torch.int32),
        "pred_counts": counts,
    }


def batched_multi_classes_nms(cls_scores, boxes, valid, nms_cfg, score_thresh=None):
    """Per-class rotated NMS (``multi_classes_nms``, model_nms_utils.py:
    28-66; JAX :86-153): class k runs :func:`batched_nms_candidates` over
    every box with its own score column, and no class suppresses another.

    cls_scores (B, N, C) sigmoid scores, boxes (B, N, 7+), valid (B, N)
    bool; ``NMS_THRESH`` a scalar or one a class.  The classes' segments
    of POST slots each are concatenated in class order and their kept
    detections compacted into the leading slots: ``pred_boxes`` (B, C *
    POST, 7+), ``pred_scores``, ``pred_labels`` (1..C), ``pred_counts``."""
    B, N, C = cls_scores.shape
    thresh = nms_cfg.NMS_THRESH
    threshes = [float(t) for t in thresh] if isinstance(thresh, (list, tuple)) \
        else [float(thresh)] * C
    outs = []
    for k in range(C):
        cfg_k = {"NMS_THRESH": threshes[k], "NMS_PRE_MAXSIZE": nms_cfg.NMS_PRE_MAXSIZE,
                 "NMS_POST_MAXSIZE": nms_cfg.NMS_POST_MAXSIZE}
        labels_k = torch.full((B, N), k + 1, dtype=torch.int32, device=boxes.device)
        outs.append(batched_nms_candidates(boxes, cls_scores[..., k], labels_k, valid,
                                           EasyDict(cfg_k), score_thresh=score_thresh))
    post = outs[0]["pred_scores"].shape[1]
    slot = torch.arange(post, device=boxes.device)[None, :]
    keep = torch.cat([slot < o["pred_counts"][:, None] for o in outs], dim=1)
    n = keep.shape[1]
    # stable compaction: the kept slots, in class order, to the front; the
    # rest onto one extra slot that is cut off
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    dst = torch.where(keep, rank, n)

    def compact(key):
        cat = torch.cat([o[key] for o in outs], dim=1)
        index = dst.reshape(dst.shape + (1,) * (cat.dim() - 2)).expand(cat.shape)
        out = cat.new_zeros((B, n + 1) + cat.shape[2:])
        return out.scatter_(1, index, cat)[:, :n]

    return {"pred_boxes": compact("pred_boxes"), "pred_scores": compact("pred_scores"),
            "pred_labels": compact("pred_labels"),
            "pred_counts": keep.sum(dim=1).to(torch.int32)}
