"""CenterNet / CenterPoint utilities: counterpart of
``pdanet_tpu/models/model_utils/centernet_utils.py``
(``pcdet/models/model_utils/centernet_utils.py``).

* ``draw_gaussians_dense`` evaluates every (padded) gt box's gaussian on
  the full grid and takes the max over the boxes, as the JAX package does:
  the reference's per-box patch drawing gives the same values.
* ``topk_heatmap`` keeps the two stages of the reference's top-K (per
  class, then across classes), each a stable descending sort, so that
  equal scores keep the lower index first, as ``lax.top_k`` does.
* ``decode_bbox_from_heatmap`` keeps the fixed top-K layout with a
  validity mask; the NMS and compaction run in the detector's batched
  post-processing.

XLA compiles a quotient by a constant as a product with the constant's
reciprocal, and folds a chain of constant factors into one: the JAX
package's jitted ``x / 0.9 / 1.1`` is ``x * (0.9 * (1 / 1.1))``, rounded in
the dtype.  Where the result is truncated to a cell or a radius, one ulp
moves it across a border, so the port computes those quotients the same
way (:func:`div_const`).
"""

import torch


def div_const(x, *divisors, times=1.0):
    """``x * times / d0 / d1 ...`` as XLA compiles it for Python or numpy
    constants: ``x`` times the one constant ``times * (1 / d0) * (1 / d1)
    ...``, each reciprocal and product rounded in ``x``'s dtype."""
    c = torch.tensor(times, dtype=x.dtype)
    for d in divisors:
        c = c * torch.reciprocal(torch.tensor(d, dtype=x.dtype))
    return x * c.to(x.device)


def gaussian_radius(height, width, min_overlap=0.5):
    """CornerNet radius rule (centernet_utils.py:9-35), element-wise."""
    b1 = height + width
    c1 = div_const(width * height, 1 + min_overlap, times=1 - min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4.0 * c1, min=0.0))) * 0.5

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 16.0 * c2, min=0.0))) * 0.5

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))) * 0.5
    return torch.minimum(torch.minimum(r1, r2), r3)


def _exp_f32(x):
    """float32 ``exp`` as the float64 one rounded once: the same bits on
    every device (the CPU's and CUDA's float32 ``exp`` differ in the last
    place, as XLA's does from both)."""
    return torch.exp(x.double()).to(torch.float32)


def draw_gaussians_dense(centers_int, radii, valid, size_xy):
    """The heatmap of one class (``draw_gaussian_to_heatmap``,
    centernet_utils.py:47-70): each valid box's gaussian of sigma
    (2 r + 1) / 6 at integer offsets from its integer centre, within
    |dx|, |dy| <= r, the max over the boxes.

    centers_int (..., M, 2) int [x, y]; radii (..., M) int; valid (..., M)
    bool; size_xy (W, H).  Returns (..., H, W) float32 whatever the gt's
    dtype, as the JAX package's; the centre cell is exp(0) * exp(0) = 1
    exactly, and a value elsewhere within an ulp of JAX's (XLA's float32
    ``exp`` is not rounded correctly)."""
    W, H = int(size_xy[0]), int(size_xy[1])
    dev = centers_int.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    dx = xs - centers_int[..., 0:1].to(torch.float32)  # (..., M, W)
    dy = ys - centers_int[..., 1:2].to(torch.float32)  # (..., M, H)
    r = radii[..., None].to(torch.float32)
    sigma = div_const(2.0 * r + 1.0, 6.0)
    two_s2 = 2.0 * sigma * sigma
    gx = _exp_f32(-(dx * dx) / two_s2)
    gy = _exp_f32(-(dy * dy) / two_s2)
    gx = torch.where((torch.abs(dx) <= r) & valid[..., None], gx, 0.0)
    gy = torch.where(torch.abs(dy) <= r, gy, 0.0)
    if gx.shape[-2] == 0:
        return gx.new_zeros(gx.shape[:-2] + (H, W))
    # the max over the boxes, one box at a time: (..., H, W) at most
    out = None
    for m in range(gx.shape[-2]):
        g = gy[..., m, :, None] * gx[..., m, None, :]
        out = g if out is None else torch.maximum(out, g)
    return out


def _sorted_topk(x, K):
    """``lax.top_k`` over the last axis: the K largest, equal values in
    index order (a stable descending sort)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :K], indices[..., :K]


def topk_heatmap(scores, K):
    """Two-stage top-K (centernet_utils.py:139-154): per class over the
    plane, then across (class, k).

    scores (B, H, W, C), already sigmoided.  Returns score (B, K), the flat
    spatial index inds (B, K) int32, class_ids (B, K) int32, ys and xs (B,
    K) in the scores' dtype."""
    B, H, W, C = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(B, C, H * W)
    cls_scores, cls_inds = _sorted_topk(flat, K)  # (B, C, K)
    topk_score, topk_ind = _sorted_topk(cls_scores.reshape(B, C * K), K)
    class_ids = torch.div(topk_ind, K, rounding_mode="floor").to(torch.int32)
    inds = torch.gather(cls_inds.reshape(B, C * K), 1, topk_ind)
    ys = torch.div(inds, W, rounding_mode="floor").to(scores.dtype)
    xs = (inds % W).to(scores.dtype)
    return topk_score, inds.to(torch.int32), class_ids, ys, xs


def gather_feat_2d(feat, inds):
    """(B, H, W, D) and (B, K) flat spatial indices -> (B, K, D)
    (``_transpose_and_gather_feat``, centernet_utils.py:122-135)."""
    B, H, W, D = feat.shape
    idx = inds.long()[..., None].expand(B, inds.shape[1], D)
    return torch.gather(feat.reshape(B, H * W, D), 1, idx)


def decode_bbox_from_heatmap(heatmap, rot_cos, rot_sin, center, center_z, dim,
                             point_cloud_range, voxel_size, feature_map_stride, vel=None,
                             K=100, score_thresh=None, post_center_limit_range=None):
    """Fixed-shape decode (centernet_utils.py:156-216).

    Channels-last maps: heatmap (B, H, W, C) sigmoided; rot_cos, rot_sin,
    center_z (B, H, W, 1); center (B, H, W, 2); dim (B, H, W, 3), already
    exp'd; vel (B, H, W, 2) or None.  Returns boxes (B, K, 7 (+2)), scores
    (B, K), labels (B, K) 0-based and valid (B, K), in decode
    (descending-score) order.  The score threshold is strict."""
    scores, inds, class_ids, ys, xs = topk_heatmap(heatmap, K)
    center = gather_feat_2d(center, inds)
    rot_sin = gather_feat_2d(rot_sin, inds)
    rot_cos = gather_feat_2d(rot_cos, inds)
    center_z = gather_feat_2d(center_z, inds)
    dim = gather_feat_2d(dim, inds)

    angle = torch.atan2(rot_sin, rot_cos)
    xs = xs[..., None] + center[..., 0:1]
    ys = ys[..., None] + center[..., 1:2]
    xs = xs * feature_map_stride * float(voxel_size[0]) + float(point_cloud_range[0])
    ys = ys * feature_map_stride * float(voxel_size[1]) + float(point_cloud_range[1])

    parts = [xs, ys, center_z, dim, angle]
    if vel is not None:
        parts.append(gather_feat_2d(vel, inds))
    boxes = torch.cat(parts, dim=-1)

    valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    if post_center_limit_range is not None:
        lim = [float(v) for v in post_center_limit_range]
        lo = torch.tensor(lim[:3], dtype=boxes.dtype, device=boxes.device)
        hi = torch.tensor(lim[3:], dtype=boxes.dtype, device=boxes.device)
        valid = valid & (boxes[..., :3] >= lo).all(dim=-1) & (boxes[..., :3] <= hi).all(dim=-1)
    if score_thresh is not None:
        valid = valid & (scores > score_thresh)
    return boxes, scores, class_ids, valid
