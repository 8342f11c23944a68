"""Loss primitives as masked fixed-shape reductions.

Counterpart of ``pdanet_tpu/utils/loss_utils.py:15-116`` (behaviour of
``pcdet/utils/loss_utils.py``): sigmoid and softmax cross entropy, smooth
L1 in its weighted and masked-mean forms, and the corner loss.  The
centernet losses come with the detectors that use them (ROADMAP queue 1
item 9).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.geometry import boxes_to_corners_3d


def sigmoid_cross_entropy_with_logits(logits, targets):
    """``max(x, 0) - x z + log1p(exp(-|x|))`` (loss_utils.py:80-97)."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def weighted_classification_loss(logits, one_hot_targets, weights):
    """Per-element sigmoid CE scaled by per-point weights: (..., C)."""
    ce = sigmoid_cross_entropy_with_logits(logits, one_hot_targets)
    return ce * weights[..., None]


def smooth_l1(diff, beta):
    """fvcore-style smooth L1 (loss_utils.py:157-165)."""
    n = torch.abs(diff)
    if beta < 1e-5:
        return n
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def weighted_smooth_l1_loss(preds, targets, weights=None, beta=1.0 / 9.0,
                            code_weights=None):
    """``WeightedSmoothL1Loss.forward`` (loss_utils.py:167-194): NaN targets
    take the prediction's value (zero loss)."""
    targets = torch.where(torch.isnan(targets), preds, targets)
    diff = preds - targets
    if code_weights is not None:
        diff = diff * torch.tensor(code_weights, dtype=diff.dtype, device=diff.device)
    loss = smooth_l1(diff, beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def smooth_l1_mean(pred, target, mask=None, beta=1.0):
    """``F.smooth_l1_loss(reduction='mean')`` over the rows ``mask``
    selects: the sum over selected rows divided by their element count."""
    loss = smooth_l1(pred - target, beta)
    if mask is None:
        return loss.mean()
    tail = int(np.prod(loss.shape[mask.dim():])) if loss.dim() > mask.dim() else 1
    m = mask.to(loss.dtype)
    mb = m.reshape(m.shape + (1,) * (loss.dim() - m.dim()))
    denom = torch.clamp(m.sum() * tail, min=1.0)
    return (loss * mb).sum() / denom


def softmax_cross_entropy(logits, labels):
    """``CrossEntropyLoss(reduction='none')``: (..., C) x (...,) int."""
    logz = F.log_softmax(logits, dim=-1)
    return -torch.gather(logz, -1, labels.long()[..., None])[..., 0]


def get_corner_loss_lidar(pred_boxes, gt_boxes):
    """8-corner smooth-L1 loss against the nearer of the gt box and its
    heading-flipped twin (loss_utils.py:340-364): (N, 7) x (N, 7) -> (N,)."""
    pred_corners = boxes_to_corners_3d(pred_boxes)
    gt_corners = boxes_to_corners_3d(gt_boxes)
    gt_flip = torch.cat([gt_boxes[:, :6], gt_boxes[:, 6:7] + np.pi], dim=1)
    gt_corners_flip = boxes_to_corners_3d(gt_flip)
    dist = torch.minimum(
        torch.linalg.vector_norm(pred_corners - gt_corners, dim=2),
        torch.linalg.vector_norm(pred_corners - gt_corners_flip, dim=2))
    return smooth_l1(dist, beta=1.0).mean(dim=1)
