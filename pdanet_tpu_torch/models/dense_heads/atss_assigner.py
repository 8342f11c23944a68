"""ATSS anchor target assigner: counterpart of ``pdanet_tpu/models/
dense_heads/atss_assigner.py`` (``pcdet/models/dense_heads/target_assigner/
atss_target_assigner.py:1-141``, https://arxiv.org/abs/1912.02424), which
``TARGET_ASSIGNER_CONFIG.NAME: ATSS`` selects; no shipped yaml names it.

Over the padded (B, M, 8) gt tensor, validity masks in place of the
reference's per-frame slicing.  The reference's quirks stay, as the JAX
package keeps them:

* the candidates' IoU std is the unbiased (K - 1) one (``torch.std``);
* the in-box BEV check bounds x_local by dy / 2 and y_local by dx / 2,
  the extents swapped (atss_target_assigner.py:110);
* every valid gt claims its largest-IoU anchor even below the adaptive
  threshold (:127-130);
* where several gts claim one anchor, the highest gt index wins (the
  reference's sequential ``index_put``).

The anchor x gt IoU is the plain ``ops/rotated_iou.boxes_iou_bev`` (or
``boxes_iou3d`` with ``MATCH_HEIGHT``), A x M, over chunks of anchors.
The K closest anchors of a gt are a stable sort of the distances (the
lower index first on a tie, as XLA's ``top_k``).
"""

import torch

from ...ops.rotated_iou import boxes_iou3d, boxes_iou_bev

_INF = float(2.0 ** 31)
IOU_CHUNK = 1 << 16  # anchors a chunk of the A x M IoU


def _anchor_gt_iou(anchors, gt, match_height):
    iou_fn = boxes_iou3d if match_height else boxes_iou_bev
    return torch.cat([iou_fn(a, gt) for a in anchors.split(IOU_CHUNK)])


def atss_assign_single(anchors, gt_boxes, gt_valid, topk, box_coder, match_height=False):
    """One frame: anchors (A, 7), gt_boxes (M, 8) padded, gt_valid (M,) ->
    labels (A,) int32 (0 background), reg_targets (A, code_size) and
    reg_weights (A,) float32."""
    A, M = anchors.shape[0], gt_boxes.shape[0]
    K = min(int(topk), A)
    dev = anchors.device
    iou = _anchor_gt_iou(anchors, gt_boxes[:, :7], match_height)
    iou = torch.where(gt_valid[None, :], iou, 0.0)  # (A, M)

    dist = torch.linalg.vector_norm(anchors[:, None, 0:3] - gt_boxes[None, :, 0:3], dim=-1)
    topk_idxs = torch.sort(dist.t(), dim=1, stable=True).indices[:, :K]  # (M, K) closest
    cand_iou = torch.gather(iou.t(), 1, topk_idxs)
    mean = cand_iou.mean(dim=1)
    var = ((cand_iou - mean[:, None]) ** 2).sum(dim=1) / max(K - 1, 1)
    thresh = mean + torch.sqrt(var) + 1e-6
    is_pos = cand_iou >= thresh[:, None]

    # the BEV in-box check of the candidates' centres, extents swapped
    d = anchors[topk_idxs, 0:3] - gt_boxes[:, None, 0:3]  # (M, K, 3)
    c = torch.cos(-gt_boxes[:, 6])[:, None]
    s = torch.sin(-gt_boxes[:, 6])[:, None]
    x_local = d[..., 0] * c - d[..., 1] * s
    y_local = d[..., 0] * s + d[..., 1] * c
    half_x = gt_boxes[:, 4][:, None] / 2.0  # dy bounds x_local
    half_y = gt_boxes[:, 3][:, None] / 2.0  # dx bounds y_local
    in_gt = ((x_local <= half_x) & (x_local >= -half_x)
             & (y_local <= half_y) & (y_local >= -half_y))
    is_pos = is_pos & in_gt & gt_valid[:, None]

    cols = torch.arange(M, device=dev)[:, None].expand(M, K)
    pos_grid = torch.zeros((A, M), dtype=torch.bool, device=dev)  # a gt's K are distinct
    pos_grid[topk_idxs.reshape(-1), cols.reshape(-1)] = is_pos.reshape(-1)
    ious_inf = torch.where(pos_grid, iou, -_INF)
    a2g_val, a2g_idx = ious_inf.max(dim=1)  # the first maximum

    # each valid gt claims its largest-IoU anchor; the highest gt wins
    g2a_max, g2a_arg = iou.max(dim=0)
    gts = torch.arange(M, device=dev)
    winner = torch.full((A,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(gt_valid, g2a_arg, 0), torch.where(gt_valid, gts, -1), "amax")
    claimed = winner >= 0
    a2g_idx = torch.where(claimed, winner, a2g_idx)
    a2g_val = torch.where(claimed, g2a_max[winner.clamp(min=0)], a2g_val)

    gt_cls = gt_boxes[:, 7].to(torch.int32)
    labels = torch.where(a2g_val <= -_INF, 0, gt_cls[a2g_idx])
    fg = labels > 0
    enc = box_coder.encode(gt_boxes[a2g_idx, :7], anchors)
    reg_targets = torch.where(fg[:, None], enc, 0.0)
    return labels, reg_targets, fg.to(torch.float32)


def atss_assign_targets(anchors_flat, gt_boxes, topk, box_coder, match_height=False):
    """The batch (reference ``assign_targets`` :16-74, one anchor set):
    anchors_flat (A, 7), every class's anchors in the head's order (ATSS
    assigns across classes at once); gt_boxes (B, M, 8) zero-padded ->
    the axis-aligned assigner's dict."""
    outs = [atss_assign_single(anchors_flat, gt, (gt[:, :7] != 0).any(dim=-1), topk,
                               box_coder, match_height) for gt in gt_boxes]
    labels, targets, weights = (torch.stack(t) for t in zip(*outs))
    return {"box_cls_labels": labels, "box_reg_targets": targets, "reg_weights": weights}
