"""ONCE eval helpers — counterpart of
``pcdet/datasets/once/once_eval/eval_utils.py`` (split parts + the
overall/distance difficulty filters)."""

import numpy as np


def compute_split_parts(num_samples, num_parts):
    part_samples = num_samples // num_parts
    remain_samples = num_samples % num_parts
    if part_samples == 0:
        return [num_samples]
    if remain_samples == 0:
        return [part_samples] * num_parts
    return [part_samples] * num_parts + [remain_samples]


def overall_filter(boxes):
    return np.zeros(boxes.shape[0], dtype=bool)


def distance_filter(boxes, level):
    ignore = np.ones(boxes.shape[0], dtype=bool)
    dist = np.sqrt(np.sum(boxes[:, 0:3] * boxes[:, 0:3], axis=1))
    if level == 0:
        flag = dist < 30
    elif level == 1:
        flag = (dist >= 30) & (dist < 50)
    elif level == 2:
        flag = dist >= 50
    else:
        raise AssertionError("level < 3 for distance metric, found %s" % level)
    ignore[flag] = False
    return ignore


def overall_distance_filter(boxes, level):
    ignore = np.ones(boxes.shape[0], dtype=bool)
    dist = np.sqrt(np.sum(boxes[:, 0:3] * boxes[:, 0:3], axis=1))
    if level == 0:
        flag = np.ones(boxes.shape[0], dtype=bool)
    elif level == 1:
        flag = dist < 30
    elif level == 2:
        flag = (dist >= 30) & (dist < 50)
    elif level == 3:
        flag = dist >= 50
    else:
        raise AssertionError("level < 4 for overall&distance, found %s" % level)
    ignore[flag] = False
    return ignore
