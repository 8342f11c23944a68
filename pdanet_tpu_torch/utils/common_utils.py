"""Host-side common utilities (numpy).

A copy of the numpy part of ``pdanet_tpu/utils/common_utils.py``
(``limit_period``, ``rotate_points_along_z_np``, ``drop_info_with_name``,
``keep_arrays_by_name``, ``create_logger``, ``set_random_seed``).  Its
multi-process pieces (``init_dist_jax``, ``merge_results_dist``) belong to
data-parallel training and are not ported yet (ROADMAP queue 1 item 8).
"""

import logging
import random

import numpy as np


def limit_period(val, offset=0.5, period=np.pi):
    """Wrap angle into [-offset*period, (1-offset)*period)
    (common_utils.py:73-80)."""
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z_np(points, angle):
    """Rotate (B, N, 3 + C) points about z by (B,) radians."""
    cosa = np.cos(angle)
    sina = np.sin(angle)
    zeros = np.zeros_like(angle)
    ones = np.ones_like(angle)
    rot = np.stack(
        [cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones], axis=1
    ).reshape(-1, 3, 3)
    xyz = np.matmul(points[:, :, 0:3], rot)
    return np.concatenate([xyz, points[:, :, 3:]], axis=-1)


def drop_info_with_name(info, name):
    """Filter annotation rows whose name == ``name`` (common_utils.py:59-66)."""
    ret = {}
    keep = [i for i, x in enumerate(info["name"]) if x != name]
    for key in info.keys():
        if key == "gt_boxes_lidar" or isinstance(info[key], np.ndarray):
            ret[key] = info[key][keep] if len(info[key]) == len(info["name"]) else info[key]
        else:
            ret[key] = info[key]
    return ret


def keep_arrays_by_name(gt_names, used_classes):
    inds = [i for i, x in enumerate(gt_names) if x in used_classes]
    return np.array(inds, dtype=np.int64)


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """Rank-0 console+file logger (common_utils.py:85-99)."""
    logger = logging.getLogger(__name__ + str(random.random()))
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    console = logging.StreamHandler()
    console.setLevel(log_level if rank == 0 else logging.ERROR)
    console.setFormatter(formatter)
    logger.addHandler(console)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setLevel(log_level if rank == 0 else logging.ERROR)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def set_random_seed(seed):
    random.seed(seed)
    np.random.seed(seed)
