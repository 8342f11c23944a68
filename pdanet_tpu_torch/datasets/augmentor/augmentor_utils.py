"""Point and box augmentations (numpy), copied from
``pdanet_tpu/datasets/augmentor/augmentor_utils.py``
(``pcdet/datasets/augmentor/augmentor_utils.py``) so that each draws in
the same order, from ``random_draws.rng()`` (numpy's global RNG unless the
loader set the sample's own generator): the world flips, rotation and
scaling (each rolls an ``enable`` Bernoulli first, ENABLE_PROB, like the
reference's np.random.choice gate), the world and local translations, the
local rotation and scaling, the world and local frustum dropouts, the
SE-SSD pyramid dropout, sparsify and swap, and CaDDN's horizontal image
flip.

``global_frustum_dropout`` also returns which boxes it keeps, so that the
augmentor drops the same rows of the boxes' names and masks (the JAX
package drops the boxes alone; ROADMAP queue 3)."""

import numpy as np

from ...utils.box_utils import boxes_to_corners_3d
from ...utils.common_utils import rotate_points_along_z_np
from ..random_draws import rng


def _enabled(enable_prob):
    return rng().choice(
        [False, True], replace=False, p=[1.0 - enable_prob, enable_prob]
    )


def random_flip_along_x(gt_boxes, points, enable_prob):
    if _enabled(enable_prob):
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 8] = -gt_boxes[:, 8]
    return gt_boxes, points


def random_flip_along_y(gt_boxes, points, enable_prob):
    if _enabled(enable_prob):
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rot_range, enable_prob):
    if _enabled(enable_prob):
        noise_rotation = rng().uniform(rot_range[0], rot_range[1])
        points = rotate_points_along_z_np(
            points[np.newaxis, :, :], np.array([noise_rotation])
        )[0]
        gt_boxes[:, 0:3] = rotate_points_along_z_np(
            gt_boxes[np.newaxis, :, 0:3], np.array([noise_rotation])
        )[0]
        gt_boxes[:, 6] += noise_rotation
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7:9] = rotate_points_along_z_np(
                np.hstack((gt_boxes[:, 7:9], np.zeros((gt_boxes.shape[0], 1))))[
                    np.newaxis, :, :
                ],
                np.array([noise_rotation]),
            )[0][:, 0:2]
    return gt_boxes, points


def global_scaling(gt_boxes, points, scale_range, enable_prob):
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    if _enabled(enable_prob):
        noise_scale = rng().uniform(scale_range[0], scale_range[1])
        points[:, :3] *= noise_scale
        gt_boxes[:, :6] *= noise_scale
    return gt_boxes, points


# --- world / local translation, local rotation and scaling, frustum and
# pyramid augmentations (JAX :73-343; the reference applies them per box in
# python loops, its boxes are tens a frame)


def random_world_translation(gt_boxes, points, offset_std, axes):
    """random_translation_along_{x,y,z} (reference :199-248): one normal
    draw per axis, applied to points and box centres."""
    for ax in axes:
        i = "xyz".index(ax)
        offset = rng().normal(0, offset_std, 1)
        points[:, i] += offset
        gt_boxes[:, i] += offset
    return gt_boxes, points


def points_in_box_mask(points, box, margin=1e-1):
    """get_points_in_box (reference :553-567): the rotated-frame extent test
    with the 0.1 m xy margin."""
    shift = points[:, 0:3] - box[0:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    lx = shift[:, 0] * c - shift[:, 1] * s
    ly = shift[:, 0] * s + shift[:, 1] * c
    return (
        (np.abs(shift[:, 2]) <= box[5] / 2.0)
        & (np.abs(lx) <= box[3] / 2.0 + margin)
        & (np.abs(ly) <= box[4] / 2.0 + margin)
    )


def random_local_translation(gt_boxes, points, offset_range, axes):
    """random_local_translation_along_{x,y,z} (reference :251-320)."""
    for ax in axes:
        i = "xyz".index(ax)
        for idx in range(gt_boxes.shape[0]):
            offset = rng().uniform(offset_range[0], offset_range[1])
            mask = points_in_box_mask(points, gt_boxes[idx])
            points[mask, i] += offset
            gt_boxes[idx, i] += offset
    return gt_boxes, points


def local_rotation(gt_boxes, points, rot_range):
    """Per-box rotation about the box centre (reference :420-464)."""
    for idx in range(gt_boxes.shape[0]):
        noise = rng().uniform(rot_range[0], rot_range[1])
        mask = points_in_box_mask(points, gt_boxes[idx])
        center = gt_boxes[idx, 0:3].copy()
        local = points[mask, :].copy()
        local[:, 0:3] -= center
        points[mask, :] = rotate_points_along_z_np(local[np.newaxis], np.array([noise]))[0]
        points[mask, 0:3] += center
        gt_boxes[idx, 6] += noise
    return gt_boxes, points


def local_scaling(gt_boxes, points, scale_range):
    """Per-box scaling about the box centre (reference :387-417)."""
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    for idx in range(gt_boxes.shape[0]):
        noise = rng().uniform(scale_range[0], scale_range[1])
        mask = points_in_box_mask(points, gt_boxes[idx])
        points[mask, 0:3] = (points[mask, 0:3] - gt_boxes[idx, 0:3]) * noise \
            + gt_boxes[idx, 0:3]
        gt_boxes[idx, 3:6] *= noise
    return gt_boxes, points


_FRUSTUM_AXIS = {"top": 2, "bottom": 2, "left": 1, "right": 1}


def global_frustum_dropout(gt_boxes, points, intensity_range, direction):
    """global_frustum_dropout_{top,bottom,left,right} (reference :320-384):
    everything past an axis threshold, a random fraction of the cloud's
    extent, drops, boxes too.  Returns (boxes, points, keep), ``keep`` the
    (N,) mask of the boxes kept."""
    i = _FRUSTUM_AXIS[direction]
    intensity = rng().uniform(intensity_range[0], intensity_range[1])
    lo, hi = np.min(points[:, i]), np.max(points[:, i])
    if direction in ("top", "left"):
        thr = hi - intensity * (hi - lo)
        keep_p, keep_b = points[:, i] < thr, gt_boxes[:, i] < thr
    else:
        thr = lo + intensity * (hi - lo)
        keep_p, keep_b = points[:, i] > thr, gt_boxes[:, i] > thr
    return gt_boxes[keep_b], points[keep_p], keep_b


def local_frustum_dropout(gt_boxes, points, intensity_range, direction):
    """local_frustum_dropout_{top,bottom,left,right} (reference :467-550):
    per box, the in-box points past a threshold cut into the box drop."""
    i = _FRUSTUM_AXIS[direction]
    for idx in range(gt_boxes.shape[0]):
        box = gt_boxes[idx]
        intensity = rng().uniform(intensity_range[0], intensity_range[1])
        d = box[5] if i == 2 else box[4]
        mask = points_in_box_mask(points, box)
        if direction in ("top", "left"):
            thr = (box[i] + d / 2) - intensity * d
            drop = mask & (points[:, i] >= thr)
        else:
            thr = (box[i] - d / 2) + intensity * d
            drop = mask & (points[:, i] <= thr)
        points = points[~drop]
    return gt_boxes, points


# --- SE-SSD pyramid augmentations (reference :570-758)

_PYRAMID_ORDERS = np.array([
    [0, 1, 5, 4], [4, 5, 6, 7], [7, 6, 2, 3],
    [3, 2, 1, 0], [1, 2, 6, 5], [0, 4, 7, 3],
])


def get_pyramids(boxes):
    """(N, 7) -> (N, 6, 15): a box face's pyramid, [apex (3) | 4 corners
    (12)]."""
    corners = boxes_to_corners_3d(boxes).reshape(-1, 8, 3)
    out = np.empty((boxes.shape[0], 6, 15), dtype=boxes.dtype)
    for f, order in enumerate(_PYRAMID_ORDERS):
        out[:, f, 0:3] = boxes[:, 0:3]
        for k, c in enumerate(order):
            out[:, f, 3 + 3 * k: 6 + 3 * k] = corners[:, c]
    return out


def _pyramid_frame(pyramid):
    """Base-corner frame of one (15,) pyramid: the origin corner, edge
    vectors v0 / v1, the apex vector v2 from the face centre."""
    apex = pyramid[0:3]
    c0, c1, c3 = pyramid[3:6], pyramid[6:9], pyramid[12:15]
    surface_center = (pyramid[3:6] + pyramid[6:9] + pyramid[9:12] + pyramid[12:15]) / 4.0
    return c0, c1 - c0, c3 - c0, apex - surface_center, surface_center


def points_in_pyramid_mask(points, pyramid):
    """The closed-form hull test: a box-face pyramid is the rectangular base
    shrunk linearly toward the apex (which projects to the face centre), so
    its (alpha, beta, gamma) base and height coordinates decide membership,
    as the reference's Delaunay ``in_hull`` does on this geometry."""
    c0, v0, v1, v2, sc = _pyramid_frame(pyramid)
    rel = points[:, 0:3] - c0
    alpha = rel @ v0 / max(v0 @ v0, 1e-12)
    beta = rel @ v1 / max(v1 @ v1, 1e-12)
    gamma = (points[:, 0:3] - sc) @ v2 / max(v2 @ v2, 1e-12)
    half = gamma / 2.0
    return (
        (gamma >= -1e-6) & (gamma <= 1.0 + 1e-6)
        & (alpha >= half - 1e-6) & (alpha <= 1.0 - half + 1e-6)
        & (beta >= half - 1e-6) & (beta <= 1.0 - half + 1e-6)
    )


def points_in_pyramids_mask(points, pyramids):
    """(M, ...) points x (K, 15) pyramids -> (M, K) bool."""
    flat = pyramids.reshape(-1, 15)
    flags = np.zeros((points.shape[0], flat.shape[0]), dtype=bool)
    for i in range(flat.shape[0]):
        flags[:, i] = points_in_pyramid_mask(points, flat[i])
    return flags


def local_pyramid_dropout(gt_boxes, points, dropout_prob, pyramids=None):
    """Drop one random face pyramid's points a selected box (reference
    :610-624)."""
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes)
    n = pyramids.shape[0]
    drop_face = rng().randint(0, 6, n)
    drop_box = rng().uniform(0, 1, n) <= dropout_prob
    if drop_box.sum() != 0:
        drop_pyr = pyramids[drop_box, drop_face[drop_box]]
        masks = points_in_pyramids_mask(points, drop_pyr)
        points = points[~masks.any(-1)]
    pyramids = pyramids[~drop_box]
    return gt_boxes, points, pyramids


def local_pyramid_sparsify(gt_boxes, points, prob, max_num_pts, pyramids=None):
    """Subsample a random face pyramid of a selected box to ``max_num_pts``
    (reference :627-657)."""
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes)
    n = pyramids.shape[0]
    if n > 0:
        face = rng().randint(0, 6, n)
        box_sel = rng().uniform(0, 1, n) <= prob
        sampled = pyramids[box_sel, face[box_sel]]
        masks = points_in_pyramids_mask(points, sampled)
        counts = masks.sum(0)
        todo = counts > max_num_pts
        if todo.sum() > 0:
            masks = masks[:, todo]
            remain = points[~masks.any(-1)]
            kept = []
            for i in range(masks.shape[1]):
                sample = points[masks[:, i]]
                sel = rng().choice(sample.shape[0], size=max_num_pts, replace=False)
                kept.append(sample[sel])
            points = np.concatenate([remain] + kept, axis=0)
        pyramids = pyramids[~box_sel]
    return gt_boxes, points, pyramids


def local_pyramid_swap(gt_boxes, points, prob, max_num_pts, pyramids=None):
    """Swap the points of two boxes' same-index face pyramids through their
    base and height ratio coordinates (reference :660-758)."""
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes)
    n = pyramids.shape[0]
    if n == 0:
        return gt_boxes, points
    swap_box = rng().uniform(0, 1, n) <= prob
    if swap_box.sum() == 0:
        return gt_boxes, points

    masks_all = points_in_pyramids_mask(points, pyramids)  # (M, n * 6)
    counts = masks_all.sum(0).reshape(n, 6)
    eligible = counts > max_num_pts  # (n, 6)
    selected = eligible & swap_box[:, None]
    if selected.sum() == 0:
        return gt_boxes, points

    def ratios(pts, pyr):
        c0, v0, v1, v2, sc = _pyramid_frame(pyr)
        alpha = (pts[:, 0:3] - c0) @ v0 / max(v0 @ v0, 1e-12)
        beta = (pts[:, 0:3] - c0) @ v1 / max(v1 @ v1, 1e-12)
        gamma = (pts[:, 0:3] - sc) @ v2 / max(v2 @ v2, 1e-12)
        return alpha, beta, gamma

    def recover(alpha, beta, gamma, pyr):
        c0, v0, v1, v2, sc = _pyramid_frame(pyr)
        return (alpha[:, None] * v0 + beta[:, None] * v1) + c0 + gamma[:, None] * v2

    drop_mask = np.zeros(points.shape[0], bool)
    extra = []
    for i in np.nonzero(swap_box)[0]:
        faces = np.nonzero(selected[i])[0]
        if faces.size == 0:
            continue
        f = rng().choice(faces)
        # the partner: another box whose same face is eligible
        partners = [j for j in range(n) if j != i and eligible[j, f]]
        if not partners:
            continue
        j = rng().choice(partners)
        mask_i = masks_all[:, i * 6 + f]
        mask_j = masks_all[:, j * 6 + f]
        pts_j = points[mask_j]
        a, b, g = ratios(pts_j, pyramids[j, f])
        swapped = pts_j.copy()
        swapped[:, 0:3] = recover(a, b, g, pyramids[i, f])
        # the intensity carried over by its min-max ratio (reference :678-681, :737-745)
        if points.shape[1] > 3 and pts_j.shape[0] > 0:
            src = points[mask_i]
            if src.shape[0] > 0:
                s_min, s_max = src[:, 3].min(), src[:, 3].max()
                j_min, j_max = pts_j[:, 3].min(), pts_j[:, 3].max()
                ratio = (pts_j[:, 3] - j_min) / max(j_max - j_min, 1e-6)
                swapped[:, 3] = ratio * (s_max - s_min) + s_min
        drop_mask |= mask_i
        extra.append(swapped)
    points = points[~drop_mask]
    if extra:
        points = np.concatenate([points] + extra, axis=0)
    return gt_boxes, points


def random_image_flip_horizontal(image, depth_map, gt_boxes, calib):
    """CaDDN's horizontal flip (reference augmentor_utils.py:160-196): on a
    fair coin, the image and the depth map flipped left-right, each box
    centre mirrored through the image (u -> W - u at its depth) and its
    heading negated."""
    if not _enabled(0.5):
        return image, depth_map, gt_boxes
    image = np.ascontiguousarray(np.fliplr(image))
    depth_map = np.ascontiguousarray(np.fliplr(depth_map))
    gt_boxes = gt_boxes.copy()
    if gt_boxes.shape[0] > 0:
        img_pts, img_depth = calib.lidar_to_img(gt_boxes[:, 0:3])
        img_pts[:, 0] = image.shape[1] - img_pts[:, 0]
        pts_rect = calib.img_to_rect(u=img_pts[:, 0], v=img_pts[:, 1], depth_rect=img_depth)
        gt_boxes[:, 0:3] = calib.rect_to_lidar(pts_rect)
        gt_boxes[:, 6] = -gt_boxes[:, 6]
    return image, depth_map, gt_boxes
