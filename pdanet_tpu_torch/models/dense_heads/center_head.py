"""CenterPoint's dense head: counterpart of ``pdanet_tpu/models/dense_heads/
center_head.py`` (``pcdet/models/dense_heads/center_head.py``).

* ``SeparateHead``: a 3x3 conv stack a target on the channels-last BEV map;
  the heatmap's output bias is -2.19 (flax's ``bias_init``, which
  ``blocks.init_random_weights`` honours through ``Conv.bias_init``).
* The target assignment is the JAX package's vectorized form: every gt
  box's gaussian on the full grid (``centernet_utils.draw_gaussians_dense``),
  the per-head class filter as masking, fixed (B, M) object slots.
* The loss is the heatmap focal loss plus the gathered L1 with
  ``code_weights``; the decode keeps the fixed top-K with a validity mask.

The module names are flax's (``shared_conv``, ``shared_bn``,
``head_{i}.{name}_conv{k}``, ``{name}_bn{k}``, ``{name}_out``), so that a
JAX variable tree maps onto the state dict (``utils/jax_weights.py``).
"""

import torch
from torch import nn

from ...utils import loss_utils
from ...utils.easydict import EasyDict
from ..blocks import BatchNorm, Conv
from ..model_utils import centernet_utils

HM_INIT_BIAS = -2.19


class SeparateHead(nn.Module):
    """Per-target conv stacks (center_head.py:11-45): for each ``name`` of
    ``head_dict`` (``{name: {out_channels, num_conv}}``), ``num_conv - 1``
    3x3 conv / BatchNorm / ReLU blocks at the input's width, then a 3x3 conv
    to ``out_channels``."""

    def __init__(self, head_dict, channels, use_bias=False, init_bias=HM_INIT_BIAS):
        super().__init__()
        self.names = list(head_dict)
        self.num_convs = {}
        for name, spec in head_dict.items():
            n = int(spec["num_conv"]) - 1
            self.num_convs[name] = n
            for k in range(n):
                self.add_module(f"{name}_conv{k}", Conv(channels, channels, 3, bias=use_bias))
                self.add_module(f"{name}_bn{k}", BatchNorm(channels))
            out = Conv(channels, int(spec["out_channels"]), 3, bias=True)
            if "hm" in name:
                out.bias_init = init_bias
                with torch.no_grad():
                    out.bias.fill_(init_bias)
            self.add_module(f"{name}_out", out)

    def forward(self, x):
        out = {}
        for name in self.names:
            h = x
            for k in range(self.num_convs[name]):
                h = torch.relu(getattr(self, f"{name}_bn{k}")(getattr(self, f"{name}_conv{k}")(h)))
            out[name] = getattr(self, f"{name}_out")(h)
        return out


class CenterHeadNet(nn.Module):
    """The shared 3x3 conv / BatchNorm / ReLU, then a ``SeparateHead`` a
    class group (center_head.py:48-101)."""

    def __init__(self, model_cfg, in_channels, num_class_each_head, head_dict):
        super().__init__()
        cfg = EasyDict(model_cfg)
        channels = int(cfg.SHARED_CONV_CHANNEL)
        use_bias = bool(cfg.get("USE_BIAS_BEFORE_NORM", False))
        self.shared_conv = Conv(in_channels, channels, 3, bias=use_bias)
        self.shared_bn = BatchNorm(channels)
        self.num_heads = len(num_class_each_head)
        for idx, n_cls in enumerate(num_class_each_head):
            hd = {k: dict(v) for k, v in dict(head_dict).items()}
            hd["hm"] = {"out_channels": n_cls, "num_conv": int(cfg.NUM_HM_CONV)}
            self.add_module(f"head_{idx}", SeparateHead(hd, channels, use_bias))

    def forward(self, spatial_features_2d):
        x = torch.relu(self.shared_bn(self.shared_conv(spatial_features_2d)))
        return [getattr(self, f"head_{i}")(x) for i in range(self.num_heads)]


def assign_targets_single_head(gt_boxes, head_class_ids, feature_map_size, feature_map_stride,
                               point_cloud_range, voxel_size, gaussian_overlap=0.1,
                               min_radius=2):
    """``assign_target_of_single_head`` (center_head.py:105-161), vectorized
    as the JAX package's.

    gt_boxes (B, M, 8) zero-padded, the 1-based global class in column 7;
    head_class_ids: the 1-based global ids of this head's classes.  Returns
    heatmap (B, H, W, C_head) float32, target_boxes (B, M, 8),
    inds (B, M) int32 and mask (B, M) bool.

    The cell of a centre is ``(x - x0) / voxel / stride`` truncated, and a
    box's extent in cells ``dx / voxel / stride``: computed as XLA compiles
    the JAX package's quotients by constants (``centernet_utils.div_const``),
    so that a centre on a cell border lands in the same cell."""
    W, H = int(feature_map_size[0]), int(feature_map_size[1])
    cls = gt_boxes[..., 7].to(torch.int32)
    nonzero = (gt_boxes[..., 0:7] != 0).any(dim=-1)
    local = torch.zeros_like(cls)
    for k, cid in enumerate(head_class_ids):
        local = torch.where(cls == int(cid), k + 1, local)
    in_head = nonzero & (local > 0)

    x, y, z = gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2]
    stride = float(feature_map_stride)
    coord_x = centernet_utils.div_const(x - float(point_cloud_range[0]),
                                        float(voxel_size[0]), stride)
    coord_y = centernet_utils.div_const(y - float(point_cloud_range[1]),
                                        float(voxel_size[1]), stride)
    coord_x = torch.clamp(coord_x, 0, W - 0.5)
    coord_y = torch.clamp(coord_y, 0, H - 0.5)
    center_int_x = coord_x.to(torch.int32)
    center_int_y = coord_y.to(torch.int32)

    dx = centernet_utils.div_const(gt_boxes[..., 3], float(voxel_size[0]), stride)
    dy = centernet_utils.div_const(gt_boxes[..., 4], float(voxel_size[1]), stride)
    radius = centernet_utils.gaussian_radius(dx, dy, gaussian_overlap)
    radius = torch.clamp(radius.to(torch.int32), min=int(min_radius))

    # the reference's skip rules (:146-150): degenerate boxes, centres off the map
    valid = in_head & (dx > 0) & (dy > 0)
    valid = valid & (center_int_x >= 0) & (center_int_x <= W)
    valid = valid & (center_int_y >= 0) & (center_int_y <= H)

    centers_int = torch.stack([center_int_x, center_int_y], dim=-1)
    heatmap = torch.stack([
        centernet_utils.draw_gaussians_dense(centers_int, radius, valid & (local == c + 1),
                                             (W, H))
        for c in range(len(head_class_ids))], dim=-1)

    ret = torch.cat([
        (coord_x - center_int_x.to(coord_x.dtype))[..., None],
        (coord_y - center_int_y.to(coord_y.dtype))[..., None],
        z[..., None],
        torch.log(torch.clamp(gt_boxes[..., 3:6], min=1e-6)),
        torch.cos(gt_boxes[..., 6:7]),
        torch.sin(gt_boxes[..., 6:7]),
    ], dim=-1)
    inds = torch.where(valid, center_int_y * W + center_int_x, 0)
    return {"heatmap": heatmap, "target_boxes": torch.where(valid[..., None], ret, 0.0),
            "inds": inds.to(torch.int32), "mask": valid}


def center_head_loss(pred_dicts, target_dicts, head_order, loss_weights):
    """Focal heatmap loss plus gathered L1 (center_head.py:236-263):
    ``(loss, tb)``."""
    total = 0.0
    tb = {}
    for idx, (pred, tgt) in enumerate(zip(pred_dicts, target_dicts)):
        hm = torch.clamp(torch.sigmoid(pred["hm"]), 1e-4, 1 - 1e-4)
        hm_loss = loss_utils.focal_loss_centernet(hm, tgt["heatmap"]) * loss_weights["cls_weight"]

        reg_pred = torch.cat([pred[k] for k in head_order], dim=-1)
        gathered = centernet_utils.gather_feat_2d(reg_pred, tgt["inds"])
        per_dim = loss_utils.reg_loss_centernet(gathered, tgt["mask"], tgt["target_boxes"])
        code_w = torch.tensor(loss_weights["code_weights"], dtype=torch.float32,
                              device=per_dim.device)[:per_dim.shape[0]]
        loc_loss = (per_dim * code_w).sum() * loss_weights["loc_weight"]

        total = total + hm_loss + loc_loss
        tb[f"hm_loss_head_{idx}"] = hm_loss
        tb[f"loc_loss_head_{idx}"] = loc_loss
    tb["rpn_loss"] = total
    return total, tb


def generate_predicted_boxes(pred_dicts, class_id_mapping_each_head, post_cfg,
                             point_cloud_range, voxel_size, feature_map_stride, head_order):
    """Decode every head and concatenate along the candidate axis
    (center_head.py:265-311): boxes (B, n_heads * K, 7), scores, labels
    (1-based global) and valid."""
    post_cfg = EasyDict(post_cfg)
    K = int(post_cfg.MAX_OBJ_PER_SAMPLE)
    all_boxes, all_scores, all_labels, all_valid = [], [], [], []
    for idx, pred in enumerate(pred_dicts):
        boxes, scores, labels, valid = centernet_utils.decode_bbox_from_heatmap(
            heatmap=torch.sigmoid(pred["hm"]), rot_cos=pred["rot"][..., 0:1],
            rot_sin=pred["rot"][..., 1:2], center=pred["center"], center_z=pred["center_z"],
            dim=torch.exp(pred["dim"]),
            vel=pred.get("vel") if "vel" in head_order else None,
            point_cloud_range=point_cloud_range, voxel_size=voxel_size,
            feature_map_stride=feature_map_stride, K=K,
            score_thresh=post_cfg.get("SCORE_THRESH", None),
            post_center_limit_range=post_cfg.POST_CENTER_LIMIT_RANGE)
        mapping = torch.tensor(list(class_id_mapping_each_head[idx]), dtype=torch.int32,
                               device=labels.device)
        all_boxes.append(boxes)
        all_scores.append(scores)
        all_labels.append(mapping[labels.long()] + 1)
        all_valid.append(valid)
    return (torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1),
            torch.cat(all_labels, dim=1), torch.cat(all_valid, dim=1))
