"""Multi-head anchor head: counterpart of ``pdanet_tpu/models/dense_heads/
anchor_head_multi.py`` (``pcdet/models/dense_heads/anchor_head_multi.py``):
a shared 3x3 conv, then one head a group of classes (``RPN_HEAD_CFGS``),
each with 1x1 cls / box / dir convs or separate 3x3 regression branches
(``SEPARATE_REG_CONFIG``).

Layout: the anchors flatten head-major, each head location-major with
its classes' anchors at a location in class order, the order of each
head's (B, H, W, A_h * code) conv output reshaped to (B, -1, code).  The
JAX package concatenates a group's per-class anchors along the x axis
(``multihead_flat_anchors``, ``np.concatenate(..., axis=-3)`` of (nz, ny,
nx, A, 7) arrays), which gives the same order for a group of one class,
every group of the shipped ``second_multihead.yaml``, but not the
predictions' order for a group of several; the port concatenates them
along the anchor axis (ROADMAP queue 3).

Module and parameter names are the flax ones (``shared_conv``,
``shared_bn``, ``head_0.conv_cls`` ...).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import parallel
from ...utils import loss_utils
from ...utils.easydict import EasyDict
from ..blocks import BatchNorm, Conv
from . import anchor_head as AH


def build_head_groups(rpn_head_cfgs, class_names):
    """Per head, the 0-based indices of its classes in ``class_names``
    (JAX :25-30)."""
    return [[list(class_names).index(n) for n in cfg["HEAD_CLS_NAME"]] for cfg in rpn_head_cfgs]


def multihead_flat_anchors(per_class_anchors, head_groups):
    """Head-major flat anchors (A_total, 7) and the anchors of each head
    (JAX :33-48): ``per_class_anchors`` the (nz, ny, nx, A_loc_c, 7)
    arrays in class order; a group's classes concatenated along the
    anchor axis, each location's anchors together."""
    flats, counts = [], []
    for grp in head_groups:
        cat = np.concatenate([np.asarray(per_class_anchors[c]) for c in grp], axis=-2)
        flat = cat.reshape(-1, cat.shape[-1])
        flats.append(flat)
        counts.append(flat.shape[0])
    return np.concatenate(flats, axis=0), counts


def assign_targets_multi(per_class_anchors, head_groups, gt_boxes, class_ids, thresholds,
                         box_coder):
    """Each head's axis-aligned assignment over its own classes, the heads
    concatenated in the layout's order (JAX :51-69)."""
    labels, targets = [], []
    for grp in head_groups:
        t = AH.assign_targets([per_class_anchors[c] for c in grp], gt_boxes,
                              [class_ids[c] for c in grp], [thresholds[c] for c in grp],
                              box_coder)
        labels.append(t["box_cls_labels"])
        targets.append(t["box_reg_targets"])
    labels = torch.cat(labels, dim=1)
    return {"box_cls_labels": labels, "box_reg_targets": torch.cat(targets, dim=1),
            "reg_weights": (labels > 0).to(torch.float32)}


class SingleHeadNet(nn.Module):
    """One group's head (JAX :72-139): 1x1 ``conv_cls`` / ``conv_box``, or
    with ``separate_reg_config`` a 3x3 branch a target (``cls_mid{k}``,
    ``cls_bn{k}``, ``cls_out``; ``reg_<name>_...``), its outputs regrouped
    to the single conv's (B, H, W, a * code) order; ``conv_dir_cls``."""

    def __init__(self, in_features, num_out_class, num_anchors_per_location, code_size,
                 use_direction_classifier=False, num_dir_bins=2, separate_reg_config=None):
        super().__init__()
        a = num_anchors_per_location
        self.a, self.code_size = a, code_size
        self.separate = separate_reg_config is not None
        if not self.separate:
            self.conv_cls = Conv(in_features, a * num_out_class, 1)
            self.conv_box = Conv(in_features, a * code_size, 1)
        else:
            scfg = EasyDict(separate_reg_config)
            n_mid, c_mid = int(scfg.NUM_MIDDLE_CONV), int(scfg.NUM_MIDDLE_FILTER)
            self.n_mid = n_mid
            self.reg_names = []
            branches = [("cls", a * num_out_class)]
            total = 0
            for reg in scfg.REG_LIST:
                name, ch = reg.split(":")
                total += int(ch)
                self.reg_names.append(f"reg_{name}")
                branches.append((f"reg_{name}", a * int(ch)))
            if total != code_size:
                raise ValueError(f"SEPARATE_REG_CONFIG.REG_LIST sums to {total}, not the "
                                 f"code size {code_size}")
            for prefix, n_out in branches:
                c = in_features
                for k in range(n_mid):
                    self.add_module(f"{prefix}_mid{k}", Conv(c, c_mid, 3, bias=False))
                    self.add_module(f"{prefix}_bn{k}", BatchNorm(c_mid, eps=1e-3,
                                                                 momentum=0.99))
                    c = c_mid
                self.add_module(f"{prefix}_out", Conv(c, n_out, 3))
        self.conv_dir_cls = (Conv(in_features, a * num_dir_bins, 1)
                             if use_direction_classifier else None)

    def _branch(self, x, prefix):
        for k in range(self.n_mid):
            x = torch.relu(getattr(self, f"{prefix}_bn{k}")(getattr(self, f"{prefix}_mid{k}")(x)))
        return getattr(self, f"{prefix}_out")(x)

    def forward(self, x):
        if not self.separate:
            cls_preds, box_preds = self.conv_cls(x), self.conv_box(x)
        else:
            cls_preds = self._branch(x, "cls")
            B, H, W = cls_preds.shape[:3]
            box_preds = torch.cat([self._branch(x, p).reshape(B, H, W, self.a, -1)
                                   for p in self.reg_names], dim=-1).reshape(
                B, H, W, self.a * self.code_size)
        dir_preds = None if self.conv_dir_cls is None else self.conv_dir_cls(x)
        return cls_preds, box_preds, dir_preds


class AnchorHeadMultiNet(nn.Module):
    """The shared conv (``SHARED_CONV_NUM_FILTER``: 3x3, BatchNorm eps 1e-3
    momentum 0.99, ReLU) and one :class:`SingleHeadNet` a group,
    ``head_{h}`` (JAX :142-184).  Returns each head's (cls, box, dir)
    maps; :func:`concat_head_preds` flattens them."""

    def __init__(self, model_cfg, in_features, head_groups, num_anchors_per_loc_per_class,
                 code_size, num_class):
        super().__init__()
        cfg = EasyDict(model_cfg)
        self.has_shared = cfg.get("SHARED_CONV_NUM_FILTER") is not None
        c = in_features
        if self.has_shared:
            c = int(cfg.SHARED_CONV_NUM_FILTER)
            self.shared_conv = Conv(in_features, c, 3, bias=False)
            self.shared_bn = BatchNorm(c, eps=1e-3, momentum=0.99)
        separate = bool(cfg.get("SEPARATE_MULTIHEAD", False))
        self.n_heads = len(head_groups)
        for h, grp in enumerate(head_groups):
            self.add_module(f"head_{h}", SingleHeadNet(
                c, len(grp) if separate else num_class,
                sum(num_anchors_per_loc_per_class[i] for i in grp), code_size,
                cfg.get("USE_DIRECTION_CLASSIFIER", False), int(cfg.get("NUM_DIR_BINS", 2)),
                cfg.get("SEPARATE_REG_CONFIG")))

    def forward(self, spatial_features_2d):
        x = spatial_features_2d
        if self.has_shared:
            x = torch.relu(self.shared_bn(self.shared_conv(x)))
        return [getattr(self, f"head_{h}")(x) for h in range(self.n_heads)]


def concat_head_preds(head_outs, head_groups, num_class, code_size, num_dir_bins, separate):
    """The heads' maps flattened to the (B, A_total, ...) layout (JAX
    :187-213); a separate head's logits fill its classes' columns, the
    others -1e9 (a sigmoid of 0)."""
    cls_list, box_list, dir_list = [], [], []
    for (cls_p, box_p, dir_p), grp in zip(head_outs, head_groups):
        B = cls_p.shape[0]
        cls_flat = cls_p.reshape(B, -1, len(grp) if separate else num_class)
        if separate:
            full = cls_flat.new_full(cls_flat.shape[:2] + (num_class,), -1e9)
            full[..., list(grp)] = cls_flat
            cls_flat = full
        cls_list.append(cls_flat)
        box_list.append(box_p.reshape(B, -1, code_size))
        if dir_p is not None:
            dir_list.append(dir_p.reshape(B, -1, num_dir_bins))
    dir_preds = torch.cat(dir_list, dim=1) if dir_list else None
    return torch.cat(cls_list, dim=1), torch.cat(box_list, dim=1), dir_preds


def anchor_head_multi_loss(head_outs, head_groups, head_anchor_counts, targets, anchors_flat,
                           num_class, loss_weights, code_size, dir_offset=0.78539,
                           num_dir_bins=2, separate=False):
    """Each head's focal loss over its own columns (``pos_cls_weight`` /
    ``neg_cls_weight``), the box and direction losses over the whole
    layout (JAX :216-297): ``(loss, tb)``."""
    labels, reg_targets = targets["box_cls_labels"], targets["box_reg_targets"]
    B = labels.shape[0]
    share = parallel.share(B, reg_targets)
    positives, negatives = labels > 0, labels == 0
    cls_weights = (loss_weights.get("neg_cls_weight", 1.0) * negatives.to(torch.float32)
                   + loss_weights.get("pos_cls_weight", 1.0) * positives.to(torch.float32))
    pos_norm = torch.clamp(positives.sum(dim=1, keepdim=True).to(torch.float32), min=1.0)
    cls_weights = cls_weights / pos_norm
    one_hot_full = F.one_hot(torch.where(labels >= 0, labels, 0).long(),
                             num_class + 1).to(torch.float32)[..., 1:]
    cls_loss, start = 0.0, 0
    for (cls_p, _, _), grp, count in zip(head_outs, head_groups, head_anchor_counts):
        cls_flat = cls_p.reshape(B, -1, len(grp) if separate else num_class)
        one_hot = one_hot_full[:, start:start + count]
        if separate:
            one_hot = one_hot[..., list(grp)]
        cls_loss = cls_loss + loss_utils.sigmoid_focal_loss(
            cls_flat, one_hot, cls_weights[:, start:start + count]).sum()
        start += count
    cls_loss = cls_loss / B * share * loss_weights["cls_weight"]

    reg_weights = positives.to(torch.float32) / pos_norm
    box_preds = torch.cat([o[1].reshape(B, -1, code_size) for o in head_outs], dim=1)
    bp_sin, rt_sin = AH.add_sin_difference(box_preds, reg_targets)
    loc_loss = (loss_utils.weighted_smooth_l1_loss(
        bp_sin, rt_sin, weights=reg_weights,
        code_weights=loss_weights.get("code_weights")).sum()
        / B * share * loss_weights["loc_weight"])
    tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
    total = cls_loss + loc_loss
    dir_list = [o[2] for o in head_outs if o[2] is not None]
    if dir_list:
        dir_preds = torch.cat([d.reshape(B, -1, num_dir_bins) for d in dir_list], dim=1)
        dir_targets = AH.get_direction_target(anchors_flat[None], reg_targets, dir_offset,
                                              num_dir_bins)
        dir_one_hot = F.one_hot(dir_targets, num_dir_bins).to(torch.float32)
        logp = F.log_softmax(dir_preds, dim=-1)
        dir_loss = -(dir_one_hot * logp).sum(dim=-1) * reg_weights
        dir_loss = dir_loss.sum() / B * share * loss_weights.get("dir_weight", 0.2)
        tb["rpn_loss_dir"] = dir_loss
        total = total + dir_loss
    tb["rpn_loss"] = total
    return total, tb
