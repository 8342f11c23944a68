"""Anchor head: counterpart of ``pdanet_tpu/models/dense_heads/
anchor_head.py`` (``pcdet/models/dense_heads/{anchor_head_template,
anchor_head_single}.py`` and ``target_assigner/{anchor_generator,
axis_aligned_target_assigner}.py``).

* The anchors are numpy constants of the static grid (``generate_anchors``,
  ``flat_anchors_per_class``, copied from the JAX package), laid out
  (nz, ny, nx, sum of sizes, rotations), class-major at each location.
* The axis-aligned target assigner is masked (B, A, M) tensor code, the
  JAX package's vmapped (A, M) form with the batch as a leading axis:
  padded gt rows are masked to IoU -1, so the reference's empty-gt and
  force-match rules hold.
* The head is three 1x1 convs on the channels-last BEV map: their
  (B, H, W, A * C) outputs reshape to (B, H * W * A, C), the anchors'
  order.

In a process group the loss's division by the batch is by the global
batch (``parallel.share``): each rank's loss is its share of the global
loss, as the JAX package's GSPMD step computes it.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import parallel
from ...utils import loss_utils
from ..blocks import Conv


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range, anchor_ndim=7):
    """``AnchorGenerator.generate_anchors`` (reference :17-61).  Returns
    (list of (nz, ny, nx, S, R, 7) float32 arrays, list of anchors a
    location)."""
    all_anchors, num_per_loc = [], []
    for cfg in anchor_generator_cfg:
        stride = cfg.get("feature_map_stride", 2)
        gx = int(grid_size[0]) // stride
        gy = int(grid_size[1]) // stride
        sizes = np.array(cfg["anchor_sizes"], dtype=np.float32)
        rotations = np.array(cfg["anchor_rotations"], dtype=np.float32)
        heights = np.array(cfg["anchor_bottom_heights"], dtype=np.float32)
        if cfg.get("align_center", False):
            x_stride = (point_cloud_range[3] - point_cloud_range[0]) / gx
            y_stride = (point_cloud_range[4] - point_cloud_range[1]) / gy
            x_offset, y_offset = x_stride / 2, y_stride / 2
        else:
            x_stride = (point_cloud_range[3] - point_cloud_range[0]) / (gx - 1)
            y_stride = (point_cloud_range[4] - point_cloud_range[1]) / (gy - 1)
            x_offset = y_offset = 0.0
        x_shifts = np.arange(point_cloud_range[0] + x_offset, point_cloud_range[3] + 1e-5,
                             x_stride, dtype=np.float32)[:gx]
        y_shifts = np.arange(point_cloud_range[1] + y_offset, point_cloud_range[4] + 1e-5,
                             y_stride, dtype=np.float32)[:gy]
        num_per_loc.append(len(rotations) * len(sizes) * len(heights))
        xg, yg, zg = np.meshgrid(x_shifts, y_shifts, heights, indexing="ij")
        anchors = np.stack([xg, yg, zg], axis=-1)  # (gx, gy, nz, 3)
        S, R = len(sizes), len(rotations)
        anchors = np.tile(anchors[:, :, :, None, :], (1, 1, 1, S, 1))
        size_t = np.broadcast_to(sizes.reshape(1, 1, 1, S, 3), anchors.shape[:4] + (3,))
        anchors = np.concatenate([anchors, size_t], axis=-1)
        anchors = np.tile(anchors[:, :, :, :, None, :], (1, 1, 1, 1, R, 1))
        rot_t = np.broadcast_to(rotations.reshape(1, 1, 1, 1, R, 1), anchors.shape[:5] + (1,))
        anchors = np.concatenate([anchors, rot_t], axis=-1)
        anchors = anchors.transpose(2, 1, 0, 3, 4, 5)  # (nz, ny, nx, S, R, 7)
        anchors[..., 2] += anchors[..., 5] / 2  # bottom -> centre z
        all_anchors.append(anchors.astype(np.float32))
    return all_anchors, num_per_loc


def flat_anchors_per_class(all_anchors):
    """The (A, 7) flat anchors in the head's per-location order (class-major
    along the anchor axis, the reference's cat on dim -3), and each class's
    (nz, ny, nx, A_loc, 7)."""
    nz, ny, nx = all_anchors[0].shape[:3]
    cat = np.concatenate(all_anchors, axis=-3)  # (nz, ny, nx, sum_S, R, 7)
    flat = cat.reshape(-1, cat.shape[-1])
    per_class = [a.reshape(nz, ny, nx, -1, 7) for a in all_anchors]
    return flat, per_class


def nearest_bev_iou(boxes_a, boxes_b):
    """``box_utils.boxes3d_nearest_bev_iou`` (reference box_utils.py:271-282):
    each rotated box snapped to its nearest axis-aligned BEV footprint, then
    the aligned IoU.  (..., A, 7) x (..., M, 7) -> (..., A, M)."""

    def aligned(boxes):
        rot = torch.abs(boxes[..., 6] - torch.floor(boxes[..., 6] / np.pi + 0.5) * np.pi)
        choose = rot[..., None] < np.pi / 4
        dims = torch.where(choose, boxes[..., [3, 4]], boxes[..., [4, 3]])
        return torch.cat([boxes[..., 0:2] - dims / 2, boxes[..., 0:2] + dims / 2], dim=-1)

    a = aligned(boxes_a)[..., :, None, :]
    b = aligned(boxes_b)[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def assign_targets_single(anchors, gt_boxes, gt_mask, box_coder, matched_threshold,
                          unmatched_threshold):
    """``AxisAlignedTargetAssigner.assign_targets_single`` (reference
    :133-210) for one class over a batch.

    anchors (A, 7) float32, whatever the gt's dtype, as the JAX package's
    are constants: the anchor-side terms (snapped footprints, diagonals)
    round in float32 there; gt_boxes (B, M, 8) zero-padded; gt_mask (B, M) bool,
    the valid rows of this class.  Returns labels (B, A) int32 and
    regression targets (B, A, code_size)."""
    B = gt_boxes.shape[0]
    iou = nearest_bev_iou(anchors, gt_boxes[..., :7])  # (B, A, M)
    iou = torch.where(gt_mask[:, None, :], iou, -1.0)
    a2g_max, a2g_arg = iou.max(dim=2)  # the first maximum
    g2a_max = iou.max(dim=1).values  # (B, M)
    g2a_max = torch.where(g2a_max == 0, -1.0, g2a_max)  # an empty gt never forces
    force = (iou == g2a_max[:, None, :]) & gt_mask[:, None, :] & (iou > 0)
    force_any = force.any(dim=2)

    gt_cls = gt_boxes[..., 7].to(torch.int32)
    cls_at_arg = torch.gather(gt_cls, 1, a2g_arg)
    labels = torch.full_like(cls_at_arg, -1)
    labels = torch.where(a2g_max < unmatched_threshold, 0, labels)
    labels = torch.where(a2g_max >= matched_threshold, cls_at_arg, labels)
    labels = torch.where(force_any, cls_at_arg, labels)

    fg = labels > 0
    tgt = torch.gather(gt_boxes, 1, a2g_arg[..., None].expand(B, -1, gt_boxes.shape[-1]))
    enc = box_coder.encode(tgt[..., :7], anchors)
    return labels, torch.where(fg[..., None], enc, 0.0)


def assign_targets(per_class_anchors, gt_boxes, class_ids, thresholds, box_coder):
    """Batch anchor target assignment (reference :36-131).

    per_class_anchors: list of (nz, ny, nx, A_loc_c, 7) tensors; gt_boxes
    (B, M, 8); class_ids: per anchor class its 1-based gt class; thresholds:
    per anchor class (matched, unmatched).  Returns (B, A) labels, (B, A,
    code) targets and (B, A) float32 regression weights, A in the head's
    per-location order."""
    nz, ny, nx = per_class_anchors[0].shape[:3]
    B = gt_boxes.shape[0]
    valid = (gt_boxes[..., :7] != 0).any(dim=-1)
    labels_list, targets_list = [], []
    for anchors_c, cid, (mt, ut) in zip(per_class_anchors, class_ids, thresholds):
        mask = valid & (gt_boxes[..., 7].to(torch.int32) == cid)
        lab, tgt = assign_targets_single(anchors_c.reshape(-1, 7), gt_boxes, mask, box_coder,
                                         mt, ut)
        labels_list.append(lab.reshape(B, nz, ny, nx, -1))
        targets_list.append(tgt.reshape(B, nz, ny, nx, -1, box_coder.code_size))
    labels = torch.cat(labels_list, dim=-1).reshape(B, -1)
    targets = torch.cat(targets_list, dim=-2).reshape(B, -1, box_coder.code_size)
    return {"box_cls_labels": labels, "box_reg_targets": targets,
            "reg_weights": (labels > 0).to(torch.float32)}


class AnchorHeadSingleNet(nn.Module):
    """1x1 conv heads (anchor_head_single.py:10-60)."""

    def __init__(self, in_features, num_class, num_anchors_per_location, code_size,
                 use_direction_classifier=True, num_dir_bins=2):
        super().__init__()
        a = num_anchors_per_location
        self.conv_cls = Conv(in_features, a * num_class, 1)
        self.conv_box = Conv(in_features, a * code_size, 1)
        self.conv_dir_cls = (Conv(in_features, a * num_dir_bins, 1)
                             if use_direction_classifier else None)

    def forward(self, spatial_features_2d):
        dir_preds = (None if self.conv_dir_cls is None
                     else self.conv_dir_cls(spatial_features_2d))
        return self.conv_cls(spatial_features_2d), self.conv_box(spatial_features_2d), dir_preds


def add_sin_difference(boxes1, boxes2, dim=6):
    """reference anchor_head_template.py:123-129."""
    rad_pred = torch.sin(boxes1[..., dim:dim + 1]) * torch.cos(boxes2[..., dim:dim + 1])
    rad_tg = torch.cos(boxes1[..., dim:dim + 1]) * torch.sin(boxes2[..., dim:dim + 1])
    b1 = torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]], dim=-1)
    b2 = torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]], dim=-1)
    return b1, b2


def get_direction_target(anchors, reg_targets, dir_offset, num_bins):
    """reference anchor_head_template.py:131-142, as class indices."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = rot_gt - dir_offset
    offset_rot = offset_rot - torch.floor(offset_rot / (2 * np.pi)) * 2 * np.pi
    return torch.clamp(torch.floor(offset_rot / (2 * np.pi / num_bins)).long(), 0, num_bins - 1)


def anchor_head_loss(cls_preds, box_preds, dir_preds, targets, anchors_flat, num_class,
                     loss_weights, dir_offset=0.78539, num_dir_bins=2):
    """Focal classification + sin-difference smooth L1 + direction cross
    entropy (anchor_head_template.py:80-180).  Returns ``(loss, tb)``.
    The weights are float32, as the JAX package computes them."""
    B = cls_preds.shape[0]
    # a mean over the frames: this rank's B of the global batch
    share = parallel.share(B, cls_preds)
    labels = targets["box_cls_labels"]
    reg_targets = targets["box_reg_targets"]

    cls_preds = cls_preds.reshape(B, -1, num_class)
    positives = labels > 0
    negatives = labels == 0
    pos_norm = torch.clamp(positives.sum(dim=1, keepdim=True).to(torch.float32), min=1.0)
    cls_weights = (negatives.to(torch.float32) + positives.to(torch.float32)) / pos_norm
    reg_weights = positives.to(torch.float32) / pos_norm

    one_hot = F.one_hot(torch.where(labels >= 0, labels, 0).long(),
                        num_class + 1).to(torch.float32)[..., 1:]
    cls_loss = (loss_utils.sigmoid_focal_loss(cls_preds, one_hot, cls_weights).sum()
                / B * share * loss_weights["cls_weight"])

    code = reg_targets.shape[-1]
    box_preds = box_preds.reshape(B, -1, code)
    bp_sin, rt_sin = add_sin_difference(box_preds, reg_targets)
    loc_loss = (loss_utils.weighted_smooth_l1_loss(
        bp_sin, rt_sin, weights=reg_weights,
        code_weights=loss_weights.get("code_weights")).sum()
        / B * share * loss_weights["loc_weight"])

    tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
    total = cls_loss + loc_loss
    if dir_preds is not None:
        dir_preds = dir_preds.reshape(B, -1, num_dir_bins)
        dir_targets = get_direction_target(anchors_flat[None], reg_targets, dir_offset,
                                           num_dir_bins)
        dir_one_hot = F.one_hot(dir_targets, num_dir_bins).to(torch.float32)
        logp = F.log_softmax(dir_preds, dim=-1)
        dir_loss = -(dir_one_hot * logp).sum(dim=-1) * reg_weights
        dir_loss = dir_loss.sum() / B * share * loss_weights["dir_weight"]
        tb["rpn_loss_dir"] = dir_loss
        total = total + dir_loss
    tb["rpn_loss"] = total
    return total, tb


def generate_predicted_boxes(cls_preds, box_preds, dir_preds, anchors_flat, box_coder,
                             num_class, dir_offset=0.78539, dir_limit_offset=0.0,
                             num_dir_bins=2):
    """reference anchor_head_template.py:182-219: (B, A, C) logits and
    (B, A, 7) boxes, the heading folded into the direction bin."""
    B = cls_preds.shape[0]
    cls_preds = cls_preds.reshape(B, -1, num_class)
    box_preds = box_preds.reshape(B, -1, box_coder.code_size)
    batch_boxes = box_coder.decode(box_preds, anchors_flat[None])
    if dir_preds is not None:
        dir_preds = dir_preds.reshape(B, -1, num_dir_bins)
        dir_labels = torch.argmax(dir_preds, dim=-1)
        period = 2 * np.pi / num_dir_bins
        val = batch_boxes[..., 6] - dir_offset
        dir_rot = val - torch.floor(val / period + dir_limit_offset) * period
        heading = dir_rot + dir_offset + period * dir_labels.to(batch_boxes.dtype)
        batch_boxes = torch.cat([batch_boxes[..., :6], heading[..., None],
                                 batch_boxes[..., 7:]], dim=-1)
    return cls_preds, batch_boxes
