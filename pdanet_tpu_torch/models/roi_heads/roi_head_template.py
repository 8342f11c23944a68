"""The two-stage (RoI) machinery that Voxel-RCNN and SECOND-IoU use:
counterpart of ``pdanet_tpu/models/roi_heads/roi_head_template.py:36-425``
(``pcdet/models/roi_heads/roi_head_template.py`` and
``target_assigner/proposal_target_layer.py``).

Every stage has a static shape, as in the JAX package:

* ``proposal_layer``: the first stage's raw logits and boxes through one
  batched rotated NMS (``model_nms_utils.batched_nms_candidates``): RoIs
  (B, NMS_POST, 7) with a validity mask.
* ``subsample_rois`` / ``sample_rois_for_rcnn``: the reference's sampler as
  masked rank selection over the frames at once: foreground RoIs without
  replacement (a random ranking), background RoIs with replacement from
  the hard and easy pools, the fg/bg split a count, not a branch.
* ``canonicalize_gt_of_rois`` / ``assign_targets``, the RoI losses and
  ``decode_roi_boxes``: masked reductions over the fixed RoI axis.
* ``roi_grid_pool_bev`` (SECOND-IoU): each RoI's rotated affine grid on
  the BEV map, sampled by ``F.grid_sample``; ``FCStack``.

The sampler's randomness is a value, ``draws``: per frame, uniforms drawn
from the frame's own generator (:func:`sampler_draws`; with the dropout
keep masks, :func:`frame_draws`).  ``fg_perm``
(N,) ranks the foreground pool, ``fg_rep`` (R,) picks foreground with
replacement (``floor(u * n_fg)``), ``hard`` and ``easy`` (R,) pick from
those pools (``floor(u * n)``, the JAX package's ``randint``).  A caller
may pass other draws (a test feeds JAX's), and the same draws on two
devices give the same sample.

In a process group the losses' normalizers (the counts of valid and
foreground RoIs) are those of the global batch, as under the JAX
package's GSPMD sums (``parallel``).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import parallel
from ...ops.geometry import rotate_points_along_z
from ...ops.rotated_iou import boxes_iou3d
from ...utils import loss_utils
from ..blocks import BatchNorm, Dense
from ..model_utils.model_nms_utils import batched_nms_candidates


def proposal_layer(batch_cls_preds, batch_box_preds, nms_cfg):
    """First-stage proposals (roi_head_template.py:45-104): ``batch_cls_preds``
    (B, N, C) raw logits (the order is monotonic in them), ``batch_box_preds``
    (B, N, 7) -> ``rois`` (B, POST, 7), ``roi_scores`` (B, POST) raw logits,
    ``roi_labels`` (B, POST) in 1..C and ``roi_valid`` (B, POST) bool."""
    scores, labels = batch_cls_preds.max(dim=-1)
    out = batched_nms_candidates(batch_box_preds, scores, labels.to(torch.int32) + 1,
                                 torch.ones_like(scores, dtype=torch.bool), nms_cfg)
    P = out["pred_boxes"].shape[1]
    roi_valid = (torch.arange(P, device=scores.device)[None, :]
                 < out["pred_counts"][:, None])
    return {"rois": out["pred_boxes"][..., :7], "roi_scores": out["pred_scores"],
            "roi_labels": out["pred_labels"], "roi_valid": roi_valid}


def sampler_draws(generator, n_rois, roi_per_image):
    """One frame's draws of :func:`subsample_rois` from ``generator`` (a CPU
    ``torch.Generator``, so that every device gets the same bits), float32
    uniforms in [0, 1): ``fg_perm`` (n_rois,), then ``fg_rep``, ``hard``
    and ``easy`` (roi_per_image,) each."""
    draw = lambda n: torch.rand(n, generator=generator, dtype=torch.float32)  # noqa: E731
    return {"fg_perm": draw(n_rois), "fg_rep": draw(roi_per_image),
            "hard": draw(roi_per_image), "easy": draw(roi_per_image)}


def _pool_sorted(mask, key=None):
    """(B, n) -> indices (B, n) with the True entries of ``mask`` first:
    ranked by ``key`` (a random permutation of the pool), or in index
    order; a stable sort, as the JAX package's ``argsort``."""
    if key is None:
        key = torch.arange(mask.shape[-1], device=mask.device, dtype=torch.float32)
    key = torch.where(mask, key.to(mask.device), torch.inf)
    return torch.sort(key, dim=-1, stable=True).indices


def _pick(pool, u, n):
    """``pool[floor(u * max(n, 1))]``, clipped into the pool's first n."""
    n = n.clamp(min=1)
    i = torch.minimum((u.to(pool.device) * n.to(torch.float32)).to(torch.int64), n - 1)
    return torch.gather(pool, 1, i)


def subsample_rois(max_overlaps, sampler_cfg, draws):
    """Fixed-shape fg/bg subsampling (proposal_target_layer.py:113-196),
    frames at once: ``max_overlaps`` (B, N), ``draws`` a dict of (B, ...)
    uniforms (:func:`sampler_draws`) -> sampled indices (B, R) int64 into
    the RoI axis, R = ``ROI_PER_IMAGE``."""
    cfg = sampler_cfg
    R = int(cfg.ROI_PER_IMAGE)
    fg_cap = int(np.round(cfg.FG_RATIO * R))
    fg_thresh = min(float(cfg.REG_FG_THRESH), float(cfg.CLS_FG_THRESH))
    B, n = max_overlaps.shape
    dev = max_overlaps.device

    fg_mask = max_overlaps >= fg_thresh
    easy_mask = max_overlaps < cfg.CLS_BG_THRESH_LO
    hard_mask = (max_overlaps < cfg.REG_FG_THRESH) & (max_overlaps >= cfg.CLS_BG_THRESH_LO)
    n_fg, n_easy, n_hard = (m.sum(dim=1, keepdim=True) for m in (fg_mask, easy_mask, hard_mask))
    n_bg = n_easy + n_hard

    # a random fg permutation (draws for more candidates than the frame's
    # proposals: the first n)
    fg_sorted = _pool_sorted(fg_mask, draws["fg_perm"][:, :n])
    hard_pool = _pool_sorted(hard_mask)
    easy_pool = _pool_sorted(easy_mask)

    # the fg/bg slot split (the reference: every slot fg when no bg exists)
    fg_this = torch.where(n_bg > 0, n_fg.clamp(max=fg_cap),
                          torch.where(n_fg > 0, R, 0))
    bg_this = R - fg_this
    # float32 product, truncated, as the JAX package computes it
    hard_cap = (bg_this.to(torch.float32) * cfg.HARD_BG_RATIO).to(torch.int64)
    hard_num = torch.where((n_hard > 0) & (n_easy > 0), torch.minimum(hard_cap, n_hard),
                           torch.where(n_hard > 0, bg_this, 0))

    s = torch.arange(R, device=dev)[None, :]
    # fg without replacement when bg exists (slots < fg_this <= n_fg), with
    # replacement otherwise (floor(rand * n_fg), :152-155)
    fg_wo = torch.gather(fg_sorted, 1, s.clamp(max=n - 1).expand(B, R))
    fg_idx = torch.where(n_bg > 0, fg_wo, _pick(fg_sorted, draws["fg_rep"], n_fg))
    bg_idx = torch.where(s - fg_this < hard_num, _pick(hard_pool, draws["hard"], n_hard),
                         _pick(easy_pool, draws["easy"], n_easy))
    idx = torch.where(s < fg_this, fg_idx, bg_idx)
    # a frame with no RoI at all samples row 0
    return torch.where(n_fg + n_bg > 0, idx, 0)


def _take(x, idx):
    """x (B, N, ...) rows ``idx`` (B, R) of each frame."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


def sample_rois_for_rcnn(proposals, gt_boxes, sampler_cfg, draws):
    """RoI sampling and gt matching (proposal_target_layer.py:13-111):
    ``proposals`` of :func:`proposal_layer`, ``gt_boxes`` (B, M, 8)
    zero-padded, ``draws`` of :func:`subsample_rois`.  The RoIs of a frame
    match its gt by 3-D IoU (by class with ``SAMPLE_ROI_BY_EACH_CLASS``);
    ``CLS_SCORE_TYPE`` ``cls`` or ``roi_iou`` sets the classification
    labels."""
    cfg = sampler_cfg
    rois, labels = proposals["rois"], proposals["roi_labels"]
    gt_valid = (gt_boxes[..., 0:7] != 0).any(dim=-1)
    iou = boxes_iou3d(rois[..., 0:7], gt_boxes[..., 0:7])  # (B, N, M)
    ok = gt_valid[:, None, :]
    if cfg.get("SAMPLE_ROI_BY_EACH_CLASS", False):
        ok = ok & (labels[..., None] == gt_boxes[..., 7].to(torch.int32)[:, None, :])
    iou = torch.where(ok, iou, -1.0)
    max_overlaps, gt_assignment = iou.max(dim=-1)  # the first maximum, as argmax
    # RoIs with no candidate keep assignment 0 / overlap 0 (:216-218)
    max_overlaps = torch.where(proposals["roi_valid"], max_overlaps.clamp(min=0.0), 0.0)

    inds = subsample_rois(max_overlaps, cfg, draws)
    roi_ious = _take(max_overlaps, inds)
    reg_valid_mask = (roi_ious > cfg.REG_FG_THRESH).to(torch.int32)
    if cfg.CLS_SCORE_TYPE == "cls":
        cls_labels = (roi_ious > cfg.CLS_FG_THRESH).to(roi_ious.dtype)
        ignore = (roi_ious > cfg.CLS_BG_THRESH) & (roi_ious < cfg.CLS_FG_THRESH)
        cls_labels = torch.where(ignore, -1.0, cls_labels)
    elif cfg.CLS_SCORE_TYPE == "roi_iou":
        fg = roi_ious > cfg.CLS_FG_THRESH
        bg = roi_ious < cfg.CLS_BG_THRESH
        soft = (roi_ious - cfg.CLS_BG_THRESH) / (cfg.CLS_FG_THRESH - cfg.CLS_BG_THRESH)
        cls_labels = torch.where(~fg & ~bg, soft, fg.to(roi_ious.dtype))
    else:
        raise NotImplementedError(cfg.CLS_SCORE_TYPE)
    return {
        "rois": _take(rois, inds),
        "gt_of_rois": _take(gt_boxes, _take(gt_assignment, inds)),
        "gt_iou_of_rois": roi_ious,
        "roi_scores": _take(proposals["roi_scores"], inds),
        "roi_labels": _take(labels, inds),
        "reg_valid_mask": reg_valid_mask,
        "rcnn_cls_labels": cls_labels,
    }


def canonicalize_gt_of_rois(rois, gt_of_rois):
    """The gt in its RoI's canonical frame, heading flipped into [-pi/2,
    pi/2] (roi_head_template.py:108-139): rois (B, R, 7), gt_of_rois (B,
    R, 8) -> (B, R, 8), the class column kept."""
    B, R = rois.shape[:2]
    roi_ry = torch.remainder(rois[..., 6], 2 * np.pi)
    shifted = torch.cat([gt_of_rois[..., 0:3] - rois[..., 0:3], gt_of_rois[..., 3:]], dim=-1)
    rotated = rotate_points_along_z(shifted.reshape(B * R, 1, -1),
                                    -roi_ry.reshape(B * R)).reshape(B, R, -1)
    heading = torch.remainder(gt_of_rois[..., 6] - roi_ry, 2 * np.pi)
    opposite = (heading > np.pi * 0.5) & (heading < np.pi * 1.5)
    heading = torch.where(opposite, torch.remainder(heading + np.pi, 2 * np.pi), heading)
    heading = torch.where(heading > np.pi, heading - 2 * np.pi, heading)
    heading = torch.clamp(heading, -np.pi / 2, np.pi / 2)
    return torch.cat([rotated[..., 0:6], heading[..., None], gt_of_rois[..., 7:]], dim=-1)


def assign_targets(proposals, gt_boxes, sampler_cfg, draws):
    """Proposal sampling and the canonical targets
    (roi_head_template.py:106-139); ``gt_of_rois_src`` keeps the lidar-frame
    gt for the corner loss."""
    t = sample_rois_for_rcnn(proposals, gt_boxes, sampler_cfg, draws)
    t["gt_of_rois_src"] = t["gt_of_rois"]
    t["gt_of_rois"] = canonicalize_gt_of_rois(t["rois"], t["gt_of_rois"])
    return t


def roi_box_cls_loss(rcnn_cls, rcnn_cls_labels, loss_cfg):
    """Binary cross entropy over the labelled RoIs (roi_head_template.py:
    209-227); a label of -1 is ignored."""
    flat = rcnn_cls.reshape(-1)
    labels = rcnn_cls_labels.reshape(-1)
    per = loss_utils.sigmoid_cross_entropy_with_logits(flat, labels.clamp(min=0.0))
    valid = (labels >= 0).to(per.dtype)
    loss = (per * valid).sum() / parallel.all_reduce_detached(valid.sum()).clamp(min=1.0)
    loss = loss * loss_cfg.LOSS_WEIGHTS["rcnn_cls_weight"]
    return loss, {"rcnn_loss_cls": loss}


def roi_box_reg_loss(forward_ret, box_coder, loss_cfg):
    """Smooth L1 on the residuals of the foreground RoIs and their corner
    loss (roi_head_template.py:140-207)."""
    code_size = box_coder.code_size
    fg_mask = (forward_ret["reg_valid_mask"] > 0).reshape(-1)
    rcnn_reg = forward_ret["rcnn_reg"].reshape(-1, code_size)
    fg = fg_mask.to(rcnn_reg.dtype)
    fg_sum = parallel.all_reduce_detached(fg.sum())
    gt_ct = forward_ret["gt_of_rois"][..., 0:code_size].reshape(-1, code_size)
    rois = forward_ret["rois"].reshape(-1, code_size)
    rois_anchor = torch.cat([torch.zeros_like(rois[:, 0:3]), rois[:, 3:6],
                             torch.zeros_like(rois[:, 6:7])], dim=-1)
    reg_targets = box_coder.encode(gt_ct, rois_anchor)
    per = loss_utils.weighted_smooth_l1_loss(
        rcnn_reg[None], reg_targets[None],
        code_weights=loss_cfg.LOSS_WEIGHTS.get("code_weights", None))[0]
    loss_reg = (per.sum(dim=-1) * fg).sum() / fg_sum.clamp(min=1.0)
    loss_reg = loss_reg * loss_cfg.LOSS_WEIGHTS["rcnn_reg_weight"]
    tb = {}
    if loss_cfg.get("CORNER_LOSS_REGULARIZATION", False):
        decoded = decode_roi_boxes(forward_ret["rois"], forward_ret["rcnn_reg"],
                                   box_coder).reshape(-1, code_size)
        src = forward_ret["gt_of_rois_src"][..., 0:code_size].reshape(-1, code_size)
        per_corner = loss_utils.get_corner_loss_lidar(decoded[:, 0:7], src[:, 0:7])
        loss_corner = (per_corner * fg).sum() / fg_sum.clamp(min=1.0)
        loss_corner = torch.where(fg_sum > 0, loss_corner, 0.0)
        loss_corner = loss_corner * loss_cfg.LOSS_WEIGHTS["rcnn_corner_weight"]
        loss_reg = loss_reg + loss_corner
        tb["rcnn_loss_corner"] = loss_corner
    tb["rcnn_loss_reg"] = loss_reg
    return loss_reg, tb


def decode_roi_boxes(rois, rcnn_reg, box_coder):
    """The residuals decoded in each RoI's frame, then rotated and moved
    back to the lidar frame (roi_head_template.py:232-261): rois (B, R,
    7), rcnn_reg (B, R, code) -> (B, R, code)."""
    B, R = rois.shape[:2]
    code_size = box_coder.code_size
    local_rois = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:]], dim=-1)
    decoded = box_coder.decode(rcnn_reg.reshape(-1, code_size),
                               local_rois.reshape(-1, code_size))
    rotated = rotate_points_along_z(decoded[:, None, :], rois[..., 6].reshape(-1))[:, 0, :]
    out = torch.cat([rotated[:, 0:3] + rois[..., 0:3].reshape(-1, 3), rotated[:, 3:]], dim=-1)
    return out.reshape(B, R, code_size)


def frame_draws(roi_cfg, roi_head, n_anchors, generators, device):
    """The draws of one two-stage training forward, one CPU
    ``torch.Generator`` a frame: ``{"sampler": {...}, "dropout": {...}}`` of
    (B, ...) tensors on ``device``, the sampler's uniforms
    (:func:`sampler_draws`) drawn first, then the dropout keep masks,
    Bernoulli(1 - ``roi_head.dp``), in the order of
    ``roi_head.dropout_shapes``.  The same generators give the same draws
    on every device.  ``n_anchors`` is the count of first-stage candidates,
    or None where the batch sets it (Part-A2-free's voxels): then the
    proposal layer's most."""
    nms_cfg = roi_cfg.NMS_CONFIG.TRAIN
    pre = int(nms_cfg.NMS_PRE_MAXSIZE)
    pre = pre if n_anchors is None else min(pre, n_anchors)
    n_rois = min(int(nms_cfg.NMS_POST_MAXSIZE), pre)
    R = int(roi_cfg.TARGET_CONFIG.ROI_PER_IMAGE)
    frames = []
    for g in generators:
        sampler = sampler_draws(g, n_rois, R)
        keep = {name: torch.rand(shape, generator=g) < 1.0 - roi_head.dp
                for name, shape in roi_head.dropout_shapes(R).items()}
        frames.append((sampler, keep))
    stack = lambda dicts: {k: torch.stack([d[k] for d in dicts]).to(device)  # noqa: E731
                           for k in dicts[0]}
    return {"sampler": stack([f[0] for f in frames]),
            "dropout": stack([f[1] for f in frames]) if frames[0][1] else {}}


def dropout(x, keep, name, rate):
    """flax's ``Dropout`` with its keep mask given: ``x / (1 - rate)`` where
    ``keep[name]`` holds, else 0."""
    return torch.where(keep[name].to(x.device), x / (1.0 - rate), 0.0)


class FCStack(nn.Module):
    """Dense (no bias) + BatchNorm (eps 1e-5, momentum 0.9) + ReLU layers
    ``fc{k}`` / ``bn{k}``, an optional biased ``out`` layer, and dropout of
    ``dp_ratio`` after the first layer in training (JAX :315-337,
    ``make_fc_layers``), its keep mask ``keep["fc0"]`` given."""

    def __init__(self, in_features, fc_list, out_features=None, dp_ratio=0.0):
        super().__init__()
        self.n, self.dp = len(fc_list), float(dp_ratio)
        c = in_features
        for k, f in enumerate(fc_list):
            self.add_module(f"fc{k}", Dense(c, f, bias=False))
            self.add_module(f"bn{k}", BatchNorm(f))
            c = f
        self.out = None if out_features is None else Dense(c, out_features)

    def dropout_shapes(self, rows):
        return {"fc0": (rows, self.fc0.out_features)} if self.dp > 0 and self.n else {}

    def forward(self, x, keep=None):
        for k in range(self.n):
            x = torch.relu(getattr(self, f"bn{k}")(getattr(self, f"fc{k}")(x)))
            if k == 0 and self.dp > 0 and self.training:
                x = dropout(x, keep, "fc0", self.dp)
        return x if self.out is None else self.out(x)


class RefineStacks(nn.Module):
    """The shared, cls and reg FC stacks of a RoI head (Dense without bias,
    BatchNorm over every RoI of the batch, ReLU; ``shared_fc<k>`` /
    ``shared_bn<k>`` ...) and the ``cls_pred`` / ``reg_pred`` layers, the
    latter from normal(0.001) with a zero bias, over the flattened pooled
    RoI features.  Dropout (``DP_RATIO``) follows the JAX package: between
    the shared stack's layers, after the first cls and reg layer (the
    reference's ``make_fc_layers``), flax's keep-and-scale form with the
    keep masks a value the caller gives (:meth:`dropout_shapes`,
    :func:`frame_draws`).  A subclass builds its pool, then calls
    :meth:`build_stacks`."""

    def build_stacks(self, cfg, in_features, code_size, num_class):
        self.dp = float(cfg.get("DP_RATIO", 0.0))
        self.stacks = {"shared": [int(f) for f in cfg.SHARED_FC],
                       "cls": [int(f) for f in cfg.CLS_FC], "reg": [int(f) for f in cfg.REG_FC]}
        c_in = {"shared": int(in_features)}
        c_in["cls"] = c_in["reg"] = self.stacks["shared"][-1]
        for prefix, widths in self.stacks.items():
            c = c_in[prefix]
            for k, f in enumerate(widths):
                self.add_module(f"{prefix}_fc{k}", Dense(c, f, bias=False))
                self.add_module(f"{prefix}_bn{k}", BatchNorm(f))
                c = f
        self.cls_pred = Dense(self.stacks["cls"][-1], num_class)
        self.reg_pred = Dense(self.stacks["reg"][-1], code_size * num_class)
        with torch.no_grad():  # flax's normal(0.001), zero bias
            self.reg_pred.weight.normal_(0.0, 0.001)
            self.reg_pred.bias.zero_()

    def _drops(self, prefix):
        """The layers of a stack followed by dropout: between the shared
        stack's layers, after the first of cls and reg."""
        n = len(self.stacks[prefix])
        return [k for k in range(n) if (k != n - 1 if prefix == "shared" else k == 0)]

    def dropout_shapes(self, rois_per_frame):
        """``{name: (R, C)}``: the keep mask a frame that each dropout takes,
        ``<prefix><k>`` after layer k of a stack; none without ``DP_RATIO``."""
        if self.dp <= 0:
            return {}
        return {f"{prefix}{k}": (rois_per_frame, self.stacks[prefix][k])
                for prefix in self.stacks for k in self._drops(prefix)}

    def _stack(self, x, prefix, keep):
        drops = self._drops(prefix)
        for k in range(len(self.stacks[prefix])):
            x = torch.relu(getattr(self, f"{prefix}_bn{k}")(getattr(self, f"{prefix}_fc{k}")(x)))
            if k in drops and self.training and self.dp > 0:
                x = dropout(x, keep, f"{prefix}{k}", self.dp)
        return x

    def refine(self, pooled, keep=None):
        """The (B, R, C) pooled features through the FC stacks ->
        ``(rcnn_cls, rcnn_reg)``."""
        if self.training and self.dp > 0 and keep is None:
            raise ValueError(f"{type(self).__name__}: training with DP_RATIO takes the dropout "
                             f"keep masks (train.make_train_step draws them)")
        shared = self._stack(pooled, "shared", keep)
        return (self.cls_pred(self._stack(shared, "cls", keep)),
                self.reg_pred(self._stack(shared, "reg", keep)))


def _div(a, d):
    """``a / d`` for a Python number ``d``, as a true division on every
    device (CUDA divides by a host scalar through its reciprocal)."""
    return a / torch.tensor(d, dtype=a.dtype, device=a.device)


def bilinear_grid_sample_2d(feat, gx, gy):
    """JAX :340-370: ``F.grid_sample(align_corners=False,
    padding_mode="zeros")`` of a channels-last (B, H, W, C) map at the
    normalized [-1, 1] points ``gx`` / ``gy`` (B, ...) -> (B, ..., C)."""
    B, H, W, C = feat.shape
    lead = gx.shape[1:]
    grid = torch.stack([gx, gy], dim=-1).reshape(B, -1, 1, 2)
    out = F.grid_sample(feat.permute(0, 3, 1, 2), grid.to(feat.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=False)  # (B, C, n, 1)
    return out[..., 0].permute(0, 2, 1).reshape((B,) + lead + (C,))


def roi_grid_pool_bev(spatial_features_2d, rois, grid_size, pc_range, voxel_size,
                      downsample_ratio):
    """Rotated RoI grid pooling from the BEV map (second_head.py:53-113, JAX
    :373-425): each RoI's affine grid of ``grid_size`` x ``grid_size``
    points (``affine_grid`` with align_corners False, its (W - 1) / (H - 1)
    denominators), sampled bilinearly.  spatial_features_2d (B, H, W, C),
    rois (B, R, 7) -> (B, R, g, g, C)."""
    B, H, W, C = spatial_features_2d.shape
    g = int(grid_size)
    sx = float(voxel_size[0]) * downsample_ratio
    sy = float(voxel_size[1]) * downsample_ratio
    x1 = _div(rois[..., 0] - rois[..., 3] / 2 - pc_range[0], sx)
    x2 = _div(rois[..., 0] + rois[..., 3] / 2 - pc_range[0], sx)
    y1 = _div(rois[..., 1] - rois[..., 4] / 2 - pc_range[1], sy)
    y2 = _div(rois[..., 1] + rois[..., 4] / 2 - pc_range[1], sy)
    cosa, sina = torch.cos(rois[..., 6]), torch.sin(rois[..., 6])
    # affine_grid's base coordinates (2i + 1) / g - 1 of a (g, g) output, in
    # float32 as XLA compiles the JAX package's: the quotient by the
    # constant g is a product with its float32 reciprocal (an ulp off the
    # true quotient for g = 7)
    base = torch.from_numpy((np.float32(2.0) * np.arange(g, dtype=np.float32)
                             + np.float32(1.0)) * np.float32(1.0 / g) - np.float32(1.0))
    base = base.to(device=rois.device, dtype=rois.dtype)
    bx, by = base[None, :], base[:, None]  # x varies along the last axis
    e = lambda t: t[..., None, None]  # noqa: E731  (B, R) -> (B, R, 1, 1)
    wx, wy = _div(x2 - x1, W - 1), _div(y2 - y1, H - 1)
    gx = e(wx) * e(cosa) * bx + e(wx) * e(-sina) * by + e(_div(x1 + x2 - W + 1, W - 1))
    gy = e(wy) * e(sina) * bx + e(wy) * e(cosa) * by + e(_div(y1 + y2 - H + 1, H - 1))
    return bilinear_grid_sample_2d(spatial_features_2d, gx, gy)
