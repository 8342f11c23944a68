"""IA-SSD / PDA-SSD point head: network, box decode, target assignment and
the loss stack.

Counterpart of ``pdanet_tpu/models/dense_heads/iassd_head.py``: the
prediction MLPs (``IASSDHeadNet``, :31-50, with the ``IOU_FC`` branch),
``assign_stack_targets`` and
``assign_targets`` (:58-218), the loss stack (:226-630) and the box decode
(``generate_predicted_boxes``, :633-643).  Every per-point tensor is dense
(B, N, ...), and every loss is a masked fixed-shape reduction.

Gradient paths follow the reference: target assignment works on detached
``centers``, ``centers_origin`` and ``encoder_coords``, and the centerness
target uses detached centres, so targets are constants; the vote loss and
the corner loss reach the vote layer through ``ctr_offsets`` and the
decoded boxes.

Data parallelism (``parallel``): every count and normalizer that reduces
over the batch -- the positives behind each classification weight, the
vote loss's per-class counts and classes present, the instances with
points, the regression weights' sum, the element count behind the
orientation residual's mean and the corner loss's positives -- is that of
the global batch, summed over the ranks.  A rank's loss is then its share
of the global loss (its own numerator over the global denominator), and
so is each tb scalar (``pos_num`` counts this rank's positives): summed
over the ranks they give the JAX package's values on the global batch.
In one process nothing changes.  The ver1/ver2 per-instance bins stay
local: an instance lies in one frame.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ... import parallel
from ...ops.chamfer import cd_loss_l1
from ...ops.geometry import enlarge_box3d, points_in_boxes, rotate_points_along_z
from ...ops.rotated_iou import paired_boxes_iou3d
from ...utils import loss_utils
from ..blocks import Dense, MLPStack


class IASSDHeadNet(nn.Module):
    """Prediction MLPs (IASSD_head.py:28-43).  With ``iou_fc`` (the yaml's
    ``IOU_FC``) a third stack, ``box_iou3d_layers`` and a Dense to one
    channel, predicts each centre's 3-D IoU; else its output is None."""

    def __init__(self, channel_in, cls_fc, reg_fc, num_class, code_size, iou_fc=None):
        super().__init__()
        self.cls_center_layers = MLPStack(channel_in, cls_fc)
        self.cls_center_out = Dense(cls_fc[-1], num_class)
        self.box_center_layers = MLPStack(channel_in, reg_fc)
        self.box_center_out = Dense(reg_fc[-1], code_size)
        self.has_iou = iou_fc is not None
        if self.has_iou:
            self.box_iou3d_layers = MLPStack(channel_in, iou_fc)
            self.box_iou3d_out = Dense(iou_fc[-1], 1)

    def forward(self, center_features):
        cls_preds = self.cls_center_out(self.cls_center_layers(center_features))
        box_preds = self.box_center_out(self.box_center_layers(center_features))
        iou_preds = (self.box_iou3d_out(self.box_iou3d_layers(center_features))
                     if self.has_iou else None)
        return cls_preds, box_preds, iou_preds


def generate_predicted_boxes(points, cls_preds, box_preds, box_coder):
    """Decode per-point boxes (point_head_template.py:193-207).

    points (B, N, 3), cls_preds (B, N, C), box_preds (B, N, code) ->
    cls_preds unchanged, boxes (B, N, 7).
    """
    pred_classes = torch.argmax(cls_preds, dim=-1)
    boxes = box_coder.decode(box_preds, points, pred_classes + 1)
    return cls_preds, boxes


# ---------------------------------------------------------------------------
# Target assignment (IASSD_head.py:132-468)
# ---------------------------------------------------------------------------


def _enlarge(gt_boxes, extra_width):
    B, M, C = gt_boxes.shape
    return enlarge_box3d(gt_boxes.reshape(-1, C), extra_width).reshape(B, M, C)


def assign_stack_targets(points, gt_boxes, extend_gt_boxes=None, *,
                         box_coder=None, ret_box_labels=False,
                         set_ignore_flag=True, use_ex_gt_assign=False):
    """Dense target assignment of points (B, N, 3) to zero-padded gt boxes
    (B, M, 8).  Returns ``point_cls_labels`` (B, N) (0 bg, -1 ignore, 1..C
    fg), ``box_idxs_labels`` (B, N) (-1 bg), ``gt_box_of_points`` (B, N, 8)
    (row 0 on bg points, never read), ``pos_mask`` (B, N) and, with
    ``ret_box_labels``, ``point_box_labels`` (B, N, 8), zero off ``pos_mask``.
    """
    box_idx = points_in_boxes(points, gt_boxes[..., 0:7])
    box_fg = box_idx >= 0
    if use_ex_gt_assign:
        ext_idx = points_in_boxes(points, extend_gt_boxes[..., 0:7])
        # instance points keep their tight-box assignment (IASSD_head.py:204)
        box_idx = torch.where(box_fg, box_idx, ext_idx)
        fg_flag = ext_idx >= 0
        ignore = torch.zeros_like(fg_flag)
    elif set_ignore_flag:
        ext_idx = points_in_boxes(points, extend_gt_boxes[..., 0:7])
        fg_flag = box_fg
        ignore = fg_flag ^ (ext_idx >= 0)
    else:
        raise NotImplementedError("assignment needs set_ignore_flag or use_ex_gt_assign")

    C = gt_boxes.shape[-1]
    safe_idx = box_idx.clamp(min=0)
    gt_of_points = torch.gather(gt_boxes, 1, safe_idx[..., None].expand(-1, -1, C))
    cls_of_points = gt_of_points[..., 7].long()
    labels = torch.where(fg_flag, cls_of_points, 0)
    labels = torch.where(ignore & ~fg_flag, -1, labels)
    # padded gt rows carry class 0: drop them from fg (IASSD_head.py:245-247)
    pos_mask = fg_flag & (labels > 0)
    out = {
        "point_cls_labels": labels,
        "box_idxs_labels": torch.where(fg_flag, box_idx, -1),
        "gt_box_of_points": gt_of_points,
        "pos_mask": pos_mask,
    }
    if ret_box_labels:
        enc = box_coder.encode(gt_of_points[..., :7], points, gt_classes=cls_of_points)
        out["point_box_labels"] = torch.where(pos_mask[..., None], enc, 0.0)
    return out


def assign_targets(batch_out, gt_boxes, target_cfg, box_coder):
    """Training targets (IASSD_head.py:279-468) for the backbone's output
    dict and gt boxes (B, M, 8).  The coordinates are detached first, as the
    reference does (IASSD_head.py:313, 400-457): targets are constants."""
    centers = batch_out["centers"].detach()
    centers_origin = batch_out["centers_origin"].detach()
    coords = [None if c is None else c.detach() for c in batch_out["encoder_coords"]]

    targets = {}
    center_t = assign_stack_targets(
        centers, gt_boxes, _enlarge(gt_boxes, target_cfg.GT_EXTRA_WIDTH),
        box_coder=box_coder, set_ignore_flag=True, ret_box_labels=True)
    targets["center_cls_labels"] = center_t["point_cls_labels"]
    targets["center_box_labels"] = center_t["point_box_labels"]
    targets["center_gt_box_of_points"] = center_t["gt_box_of_points"]
    targets["center_pos_mask"] = center_t["pos_mask"]

    if target_cfg.get("INS_AWARE_ASSIGN", False):
        ext_05 = _enlarge(gt_boxes, [0.5, 0.5, 0.5])
        sa = {"sa_ins_labels": [], "sa_gt_box_of_points": [], "sa_pos_masks": [],
              "sa_box_idxs_labels": []}
        # coords[1..5] = [L0, L1, L2, L3, centers_origin]; layer 1 takes
        # the ignore-ring assignment, the later ones the extended-gt one
        # (IASSD_head.py:348-383)
        for i in range(1, len(batch_out["sa_ins_preds"])):
            if i == 1:
                t = assign_stack_targets(coords[i], gt_boxes, ext_05,
                                         set_ignore_flag=True)
            else:
                t = assign_stack_targets(coords[i], gt_boxes, ext_05,
                                         set_ignore_flag=False, use_ex_gt_assign=True)
            sa["sa_ins_labels"].append(t["point_cls_labels"])
            sa["sa_gt_box_of_points"].append(t["gt_box_of_points"])
            sa["sa_pos_masks"].append(t["pos_mask"])
            sa["sa_box_idxs_labels"].append(t["box_idxs_labels"])
        targets.update(sa)

    extra = target_cfg.get("ASSIGN_METHOD", None)
    if extra is not None and extra.NAME == "extend_gt":
        pts = (centers_origin if extra.get("ASSIGN_TYPE", "centers") == "centers_origin"
               else centers)
        t = assign_stack_targets(
            pts, gt_boxes, _enlarge(gt_boxes, extra.EXTRA_WIDTH),
            box_coder=box_coder, ret_box_labels=True, set_ignore_flag=False,
            use_ex_gt_assign=True)
        targets["center_origin_cls_labels"] = t["point_cls_labels"]
        targets["center_origin_box_idxs_of_pts"] = t["box_idxs_labels"]
        targets["gt_box_of_center_origin"] = t["gt_box_of_points"]
        targets["center_origin_pos_mask"] = t["pos_mask"]
    return targets


# ---------------------------------------------------------------------------
# Losses (IASSD_head.py:470-1340)
# ---------------------------------------------------------------------------


def _one_hot_fg(labels, num_class, dtype):
    """One-hot over classes 1..C; background and ignored rows all zero."""
    clipped = torch.where(labels >= 0, labels, 0)
    return F.one_hot(clipped, num_class + 1).to(dtype)[..., 1:]


def _cls_weights(labels, dtype):
    """(positive | negative) / max(num_pos, 1), ignored rows 0, num_pos
    the positives of the global batch; and this rank's positives."""
    positives = labels > 0
    weights = (positives | (labels == 0)).to(dtype)
    num_pos = positives.sum()
    norm = parallel.all_reduce_detached(num_pos).to(dtype)
    return weights / torch.clamp(norm, min=1.0), num_pos.to(dtype)


def contextual_vote_loss(forward_ret, num_class, weight):
    """LOSS_VOTE_TYPE 'none' (IASSD_head.py:525-548): per-class smooth L1
    of ``centers_origin + ctr_offsets`` against the gt centres, averaged
    over the classes present in the batch."""
    labels = forward_ret["center_origin_cls_labels"]
    gt_ctr = forward_ret["gt_box_of_center_origin"][..., 0:3]
    pred = forward_ret["centers_origin"] + forward_ret["ctr_offsets"]
    per_elem = loss_utils.smooth_l1(pred - gt_ctr, beta=1.0)  # (B, N, 3)
    sums, cnts = [], []
    for k in range(1, num_class + 1):
        m = (labels == k).to(per_elem.dtype)
        sums.append((per_elem * m[..., None]).sum())
        cnts.append(m.sum())
    cnts = parallel.all_reduce_detached(torch.stack(cnts))
    losses = torch.stack(sums) / torch.clamp(cnts * 3.0, min=1.0)
    present = (cnts > 0).to(per_elem.dtype)
    return (losses * present).sum() / torch.clamp(present.sum(), min=1.0) * weight


def _instance_segments(forward_ret, num_boxes):
    """Per-point instance bins for the ver1/ver2 vote losses: point n of
    frame b goes to bin ``b * num_boxes + box``; background points go to
    the overflow bin ``B * num_boxes``, which no loss term reads.  Returns
    the flat bins (B*N,), the foreground weights (B*N,), the per-bin point
    counts (B*num_boxes + 1,), the flat votes (B*N, 3) and the per-point
    smooth-L1 to the gt centre, summed over xyz (B*N,)."""
    box_idx = forward_ret["center_origin_box_idxs_of_pts"]  # (B, N)
    gt_ctr = forward_ret["gt_box_of_center_origin"][..., 0:3]
    pred = forward_ret["centers_origin"] + forward_ret["ctr_offsets"]
    B = box_idx.shape[0]
    valid = box_idx >= 0
    seg = (torch.arange(B, device=box_idx.device)[:, None] * num_boxes
           + box_idx.clamp(min=0)).reshape(-1)
    seg = torch.where(valid.reshape(-1), seg, B * num_boxes)
    num_seg = B * num_boxes + 1
    # float32 at least, as the JAX package's weights: counts stay exact
    ones = valid.reshape(-1).to(torch.promote_types(pred.dtype, torch.float32))
    counts = _segment_sum(ones, seg, num_seg)
    l1 = loss_utils.smooth_l1(pred - gt_ctr, beta=1.0).sum(dim=-1).reshape(-1)
    return seg, ones, counts, pred.reshape(-1, 3), l1


def _segment_sum(values, seg, num_seg):
    out = values.new_zeros((num_seg,) + values.shape[1:])
    return out.index_add(0, seg, values)


def _mean_over_instances(per_ins, counts):
    """Mean of the per-instance terms over the instances with points."""
    has_pts = (counts[:-1] > 0).to(per_ins.dtype)
    n_ins = parallel.all_reduce_detached(has_pts.sum())
    return (per_ins * has_pts).sum() / torch.clamp(n_ins, min=1.0)


def contextual_vote_loss_ver1(forward_ret, num_boxes, weight):
    """LOSS_VOTE_TYPE 'ver1' (IASSD_head.py:551-576): the per-instance
    mean smooth L1 of the votes, averaged over the instances with points.
    ``num_boxes`` is the gt axis of the collated batch."""
    seg, ones, counts, _, l1 = _instance_segments(forward_ret, num_boxes)
    ins_loss = _segment_sum(l1 * ones, seg, counts.shape[0])
    per_ins = ins_loss[:-1] / torch.clamp(counts[:-1], min=1.0)
    return _mean_over_instances(per_ins, counts) * weight


def contextual_vote_loss_ver2(forward_ret, num_boxes, weight):
    """LOSS_VOTE_TYPE 'ver2' (IASSD_head.py:583-625): ver1 plus half the
    per-instance mean smooth L1 of each vote to its instance's mean vote.
    The gradient flows through the instance means too, as in the JAX
    package, which stops no gradient there."""
    seg, ones, counts, pred, l1 = _instance_segments(forward_ret, num_boxes)
    num_seg = counts.shape[0]
    ins_loss = _segment_sum(l1 * ones, seg, num_seg)
    sums = _segment_sum(pred * ones[:, None], seg, num_seg)
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    spread = loss_utils.smooth_l1(pred - means[seg], beta=1.0).sum(dim=-1)
    ins_mean_loss = _segment_sum(spread * ones, seg, num_seg)
    per_ins = (ins_loss[:-1] + 0.5 * ins_mean_loss[:-1]) / torch.clamp(
        counts[:-1], min=1.0)
    return _mean_over_instances(per_ins, counts) * weight


def generate_center_ness_mask(forward_ret):
    """Box-geometry centerness ``(min / max)^(1/3)`` of the positive
    centres (IASSD_head.py:795-818), on detached centres (:799, :336): a
    target, never a gradient path into the votes."""
    pos = forward_ret["center_pos_mask"]
    gt = forward_ret["center_gt_box_of_points"]
    off = forward_ret["centers"].detach() - gt[..., 0:3]
    off_canon = rotate_points_along_z(off[..., None, :], -gt[..., 6])[..., 0, :]
    half = gt[..., 3:6] / 2.0
    dist_pos = half - off_canon
    dist_neg = half + off_canon
    dmin = torch.minimum(dist_pos, dist_neg)
    dmax = torch.maximum(dist_pos, dist_neg)
    centerness = dmin / torch.where(dmax == 0, 1e-6, dmax)
    centerness = torch.clamp(
        centerness[..., 0] * centerness[..., 1] * centerness[..., 2], min=1e-6
    ) ** (1.0 / 3.0)
    return torch.where(pos, centerness, 0.0)


# per-class covariance multipliers of the gauss heatmap
# (gauss_fun_once_topk_GT_add_same_size, IASSD_head.py:922-940)
_GAUSS_CLASS_MULT = torch.tensor([1.0, 4.0, 6.0, 5.0], dtype=torch.float32)


def gauss_centerness_mask(xyz, pos_mask, gt_of_points):
    """Gaussian-heatmap centerness of one SA layer's points (B, N, 3)
    (IASSD_head.py:889-942); 0 on background."""
    gt = gt_of_points
    off = xyz - gt[..., 0:3]
    off_canon = rotate_points_along_z(off[..., None, :], -gt[..., 6])[..., 0, :]
    w, l, h = gt[..., 3], gt[..., 4], gt[..., 5]
    eps = 1e-8
    cov1 = 4.0 / (w ** 2 + l ** 2 + eps)
    cov2 = 4.0 / (w ** 2 + h ** 2 + eps)
    cov3 = 4.0 / (h ** 2 + l ** 2 + eps)
    mult = _GAUSS_CLASS_MULT.to(gt.device)[torch.clamp(gt[..., 7].long(), 0, 3)]
    scaled = torch.stack([off_canon[..., 0] * cov1 * mult,
                          off_canon[..., 1] * cov2 * mult,
                          off_canon[..., 2] * cov3 * mult], dim=-1)
    hm = torch.exp(-0.5 * (scaled * scaled).sum(dim=-1))
    return torch.where(pos_mask, hm, 0.0)


def _cls_loss(logits, one_hot, cls_w):
    return loss_utils.weighted_classification_loss(logits, one_hot, cls_w).mean(dim=-1).sum()


def sa_ins_layer_loss(forward_ret, loss_cfg, num_class):
    """Per-SA-layer semantic loss (IASSD_head.py:668-736)."""
    sa_labels = forward_ret["sa_ins_labels"]
    sa_preds = forward_ret["sa_ins_preds"]
    weights_list = loss_cfg.LOSS_WEIGHTS.get("ins_aware_weight", [1.0] * len(sa_labels))
    total, ignored, tb = 0.0, 0, {}
    for i in range(len(sa_labels)):
        if sa_preds[i] is None:
            ignored += 1
            continue
        logits, labels = sa_preds[i], sa_labels[i]
        cls_w, pos_num = _cls_weights(labels, logits.dtype)
        one_hot = _one_hot_fg(labels, num_class, logits.dtype)
        method = loss_cfg.SAMPLE_METHOD_LIST[i + 1]
        if method and "ctr" in method[0]:
            # sa_ins_labels[i] was assigned on encoder_coords[i + 1]
            mask = gauss_centerness_mask(
                forward_ret["encoder_coords"][i + 1],
                forward_ret["sa_pos_masks"][i], forward_ret["sa_gt_box_of_points"][i])
            one_hot = one_hot * mask[..., None]
        loss = _cls_loss(logits, one_hot, cls_w) * weights_list[i]
        total = total + loss
        tb[f"sa{i}_loss_ins"] = loss
        tb[f"sa{i}_pos_num"] = pos_num
    total = total / max(len(sa_labels) - ignored, 1)
    tb["sa_loss_ins"] = total
    return total, tb


def center_cls_layer_loss(forward_ret, loss_cfg, num_class):
    """Centre classification with centerness targets (IASSD_head.py:637-664)."""
    labels = forward_ret["center_cls_labels"]
    logits = forward_ret["center_cls_preds"]
    cls_w, pos_num = _cls_weights(labels, logits.dtype)
    one_hot = _one_hot_fg(labels, num_class, logits.dtype)
    if loss_cfg.CENTERNESS_REGULARIZATION:
        one_hot = one_hot * generate_center_ness_mask(forward_ret)[..., None]
    loss = _cls_loss(logits, one_hot, cls_w) * loss_cfg.LOSS_WEIGHTS["point_cls_weight"]
    return loss, {"center_loss_cls": loss, "center_pos_num": pos_num}


def center_box_binori_layer_loss(forward_ret, loss_cfg, box_coder):
    """Box regression: smooth-L1 xyz/size, bin CE and in-bin residual
    (IASSD_head.py:1239-1282).  The reference's quirk stays: the residual
    term is the mean over ALL points, background included, times
    ``sum(reg_w)`` (:1266-1268, JAX :475-477)."""
    pos = forward_ret["center_pos_mask"]
    labels = forward_ret["center_box_labels"]  # (B, N, 8)
    preds = forward_ret["center_box_preds"]  # (B, N, 6 + 2 bins)
    bin_size = box_coder.bin_size
    reg_w = pos.to(preds.dtype)
    reg_w = reg_w / torch.clamp(parallel.all_reduce_detached(reg_w.sum()), min=1.0)

    lw = loss_cfg.LOSS_WEIGHTS
    loss_xyzwhl = loss_utils.weighted_smooth_l1_loss(
        preds[..., :6], labels[..., :6], weights=reg_w,
        code_weights=lw.get("code_weights", None)).sum()
    bin_logits = preds[..., 6:6 + bin_size]
    bin_res_pred = preds[..., 6 + bin_size:]
    bin_id = labels[..., 6].long()
    loss_ori_cls = (loss_utils.softmax_cross_entropy(bin_logits, bin_id) * reg_w).sum()
    picked = torch.gather(bin_res_pred, -1, bin_id[..., None])[..., 0]
    res = loss_utils.smooth_l1(picked - labels[..., 7], beta=1.0)
    loss_ori_reg = (res.mean() * parallel.share(res.numel(), res)
                    * parallel.all_reduce_detached(reg_w.sum()))
    loss_ori_cls = loss_ori_cls * lw.get("dir_weight", 1.0)
    loss_box = (loss_xyzwhl + loss_ori_reg + loss_ori_cls) * lw["point_box_weight"]
    return loss_box, {
        "center_loss_box": loss_box,
        "center_loss_box_xyzwhl": loss_xyzwhl,
        "center_loss_box_ori_bin": loss_ori_cls,
        "center_loss_box_ori_res": loss_ori_reg,
    }


def corner_layer_loss(forward_ret, loss_cfg):
    """8-corner loss over the positive centres (IASSD_head.py:1309-1323)."""
    pos = forward_ret["center_pos_mask"]
    gt = forward_ret["center_gt_box_of_points"]
    pred = forward_ret["point_box_preds"]  # decoded (B, N, 7)
    B, N = pos.shape
    per_box = loss_utils.get_corner_loss_lidar(
        pred.reshape(B * N, 7), gt[..., 0:7].reshape(B * N, 7)).reshape(B, N)
    m = pos.to(per_box.dtype)
    loss = (per_box * m).sum() / torch.clamp(parallel.all_reduce_detached(m.sum()), min=1.0)
    loss = loss * loss_cfg.LOSS_WEIGHTS["corner_weight"]
    return loss, {"corner_loss_reg": loss}


def iou3d_layer_loss(forward_ret, loss_cfg):
    """IoU-quality regression (IASSD_head.py:1324-1340; JAX :505-529), with
    ``IOU_FC``: smooth L1 (beta 1) of the IoU head's output against the
    3-D IoU of each positive centre's decoded box (detached) and its gt
    box, meaned over the positives, times ``iou3d_weight``."""
    pos = forward_ret["center_pos_mask"]
    gt = forward_ret["center_gt_box_of_points"][..., 0:7]
    pred = forward_ret["point_box_preds"].detach()
    B, N = pos.shape
    targets = paired_boxes_iou3d(pred.reshape(B * N, 7), gt.reshape(B * N, 7)).reshape(B, N)
    preds = forward_ret["box_iou3d_preds"][..., 0]
    m = pos.to(preds.dtype)
    per = loss_utils.smooth_l1(preds - targets.detach(), beta=1.0)
    loss = (per * m).sum() / torch.clamp(parallel.all_reduce_detached(m.sum()), min=1.0)
    loss = loss * forward_ret.get(
        "iou3d_weight", loss_cfg.LOSS_WEIGHTS.get("iou3d_weight", 1.0))
    return loss, {"iou3d_loss_reg": loss}


@torch.no_grad()
def cd_loss_metric(forward_ret, loss_cfg):
    """The ``CD_loss`` scalar (IASSD_head.py:700-731): for every SA layer
    whose sampling is ctr-aware, the L1 chamfer distance between its
    coordinates and a same-size set from the previous layer (foreground by
    Gaussian centerness first, then the background points nearest to a
    foreground gt centre).  Logged with no gradient, weighted out of the
    total (:730).  A stable descending sort stands for the JAX package's
    ``top_k``: ties keep the lower index, so the chosen set is the same."""
    method_list = loss_cfg.SAMPLE_METHOD_LIST
    coords = forward_ret["encoder_coords"]
    masks = forward_ret["sa_pos_masks"]
    gts = forward_ret["sa_gt_box_of_points"]
    cds = []
    for i in range(1, len(masks)):
        if not (method_list[i] and "ctr" in method_list[i][0]):
            continue
        prev_xyz, cur_xyz = coords[i], coords[i + 1]
        hm = gauss_centerness_mask(prev_xyz, masks[i - 1], gts[i - 1])
        ctrs = gts[i - 1][..., 0:3]
        dx = prev_xyz[:, :, 0:1] - ctrs[:, None, :, 0]
        dy = prev_xyz[:, :, 1:2] - ctrs[:, None, :, 1]
        dz = prev_xyz[:, :, 2:3] - ctrs[:, None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz  # (B, Np, Np)
        d2 = torch.where(masks[i - 1][:, None, :], d2, torch.inf)
        d2min = d2.min(dim=-1).values
        d2min = torch.where(torch.isfinite(d2min), d2min, 1e9)
        key = torch.where(hm > 0, 1e6 + hm, -d2min)
        idx = torch.sort(key, dim=-1, descending=True, stable=True).indices
        idx = idx[:, :cur_xyz.shape[1]]
        sel = torch.gather(prev_xyz, 1, idx[..., None].expand(-1, -1, 3))
        cds.append(cd_loss_l1(cur_xyz, sel))
    if not cds:
        return None
    # each distance is a mean over the frames: this rank's share of it
    return sum(cds) / len(cds) * parallel.share(coords[0].shape[0], cds[0])


def get_loss(forward_ret, model_cfg, box_coder, num_class, num_boxes):
    """Total head loss and its tb scalars (IASSD_head.py:470-521).
    ``num_boxes`` is the gt axis M of the (B, M, 8) gt boxes."""
    loss_cfg = model_cfg.LOSS_CONFIG
    target_cfg = model_cfg.TARGET_CONFIG
    tb = {}

    vote_type = loss_cfg.get("LOSS_VOTE_TYPE", "none")
    assign = target_cfg.get("ASSIGN_METHOD", None)
    vote_w = loss_cfg.LOSS_WEIGHTS["vote_weight"]
    if assign is not None and assign.get("ASSIGN_TYPE") == "centers_origin":
        if vote_type == "ver2":
            vote_loss = contextual_vote_loss_ver2(forward_ret, num_boxes, vote_w)
        elif vote_type == "ver1":
            vote_loss = contextual_vote_loss_ver1(forward_ret, num_boxes, vote_w)
        else:
            vote_loss = contextual_vote_loss(forward_ret, num_class, vote_w)
    else:
        # centre-assign variant (IASSD_head.py:628-634)
        pred = forward_ret["centers_origin"] + forward_ret["ctr_offsets"]
        vote_loss = loss_utils.smooth_l1_mean(
            pred, forward_ret["center_gt_box_of_points"][..., 0:3],
            mask=forward_ret["center_pos_mask"])
    tb["vote_loss"] = vote_loss

    sa_loss = 0.0
    if loss_cfg.get("LOSS_INS", None) is not None:
        sa_loss, tb_sa = sa_ins_layer_loss(forward_ret, loss_cfg, num_class)
        tb.update(tb_sa)
        if "sa_pos_masks" in forward_ret and loss_cfg.get("LOG_CD_METRIC", True):
            cd = cd_loss_metric(forward_ret, loss_cfg)
            if cd is not None:
                tb["CD_loss"] = cd

    cls_loss, tb_cls = center_cls_layer_loss(forward_ret, loss_cfg, num_class)
    tb.update(tb_cls)
    box_loss, tb_box = center_box_binori_layer_loss(forward_ret, loss_cfg, box_coder)
    tb.update(tb_box)
    corner_loss = 0.0
    if loss_cfg.get("CORNER_LOSS_REGULARIZATION", False):
        corner_loss, tb_c = corner_layer_loss(forward_ret, loss_cfg)
        tb.update(tb_c)
    iou3d_loss = 0.0
    if model_cfg.get("IOU_FC", None) is not None and \
            forward_ret.get("box_iou3d_preds") is not None:
        iou3d_loss, tb_iou = iou3d_layer_loss(forward_ret, loss_cfg)
        tb.update(tb_iou)

    total = vote_loss + sa_loss + cls_loss + box_loss + corner_loss + iou3d_loss
    tb["point_loss"] = total
    return total, tb
