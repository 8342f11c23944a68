"""World-level augmentations (numpy): the PDA-SSD subset of
``pdanet_tpu/datasets/augmentor/augmentor_utils.py``
(``pcdet/datasets/augmentor/augmentor_utils.py`` :45-165), copied so that
each draws in the same order, from ``random_draws.rng()`` (numpy's global
RNG unless the loader set the sample's own generator).  Each augment rolls
an ``enable`` Bernoulli first (ENABLE_PROB), like the reference's
np.random.choice gate."""

import numpy as np

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
