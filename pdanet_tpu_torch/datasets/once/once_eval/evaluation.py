"""Official ONCE benchmark evaluation (numpy port).

Counterpart of ``pcdet/datasets/once/once_eval/evaluation.py``: superclass
Vehicle/Pedestrian/Cyclist with IoU thresholds 0.7/0.3/0.5, 50-point PR
sampling, difficulties overall + 0-30 / 30-50 / 50-inf m, heading-aware 3D
IoU (pairs with >90 deg heading difference are unmatched).  The numba.cuda
rotated IoU becomes the KITTI eval's ``rotate_iou_eval`` (the g++ host
library's rotated overlap).
"""

import numpy as np

from ...kitti.kitti_object_eval_python.rotate_iou import rotate_iou_eval
from .eval_utils import (
    compute_split_parts,
    distance_filter,
    overall_distance_filter,
    overall_filter,
)

iou_threshold_dict = {
    "Car": 0.7, "Bus": 0.7, "Truck": 0.7, "Pedestrian": 0.3, "Cyclist": 0.5,
}
superclass_iou_threshold_dict = {"Vehicle": 0.7, "Pedestrian": 0.3, "Cyclist": 0.5}


def get_thresholds(scores, num_gt, num_pr_points):
    """reference evaluation.py:160-182 (with the eps recall fix)."""
    eps = 1e-6
    scores = np.sort(scores)[::-1]
    recall_level = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < (len(scores) - 1) else l_recall
        if (r_recall + l_recall < 2 * recall_level) and i < (len(scores) - 1):
            continue
        thresholds.append(score)
        recall_level += 1 / num_pr_points
        while r_recall + l_recall + eps > 2 * recall_level:
            thresholds.append(score)
            recall_level += 1 / num_pr_points
    return thresholds


def accumulate_scores(iou, pred_scores, gt_flag, pred_flag, iou_threshold):
    """reference evaluation.py:184-215."""
    num_gt, num_pred = iou.shape
    assigned = np.full(num_pred, False)
    accum = []
    for i in range(num_gt):
        if gt_flag[i] == -1:
            continue
        det_idx = -1
        detected_score = -1
        for j in range(num_pred):
            if pred_flag[j] == -1 or assigned[j]:
                continue
            if iou[i, j] > iou_threshold and pred_scores[j] > detected_score:
                det_idx = j
                detected_score = pred_scores[j]
        if detected_score == -1 and gt_flag[i] == 0:
            pass
        elif detected_score != -1 and (gt_flag[i] == 1 or pred_flag[det_idx] == 1):
            assigned[det_idx] = True
        elif detected_score != -1:
            accum.append(pred_scores[det_idx])
            assigned[det_idx] = True
    return np.array(accum)


def compute_statistics(iou, pred_scores, gt_flag, pred_flag, score_threshold,
                       iou_threshold):
    """reference evaluation.py:217-263."""
    num_gt, num_pred = iou.shape
    assigned = np.full(num_pred, False)
    under_threshold = pred_scores < score_threshold
    tp, fp, fn = 0, 0, 0
    for i in range(num_gt):
        if gt_flag[i] == -1:
            continue
        det_idx = -1
        detected = False
        best_matched_iou = 0
        gt_assigned_to_ignore = False
        for j in range(num_pred):
            if pred_flag[j] == -1 or assigned[j] or under_threshold[j]:
                continue
            iou_ij = iou[i, j]
            if (
                iou_ij > iou_threshold
                and (iou_ij > best_matched_iou or gt_assigned_to_ignore)
                and pred_flag[j] == 0
            ):
                best_matched_iou = iou_ij
                det_idx = j
                detected = True
                gt_assigned_to_ignore = False
            elif iou_ij > iou_threshold and (not detected) and pred_flag[j] == 1:
                det_idx = j
                detected = True
                gt_assigned_to_ignore = True
        if (not detected) and gt_flag[i] == 0:
            fn += 1
        elif detected and (gt_flag[i] == 1 or pred_flag[det_idx] == 1):
            assigned[det_idx] = True
        elif detected:
            tp += 1
            assigned[det_idx] = True
    for j in range(num_pred):
        if not (assigned[j] or pred_flag[j] == -1 or pred_flag[j] == 1
                or under_threshold[j]):
            fp += 1
    return tp, fp, fn


def compute_statistics_all_thresholds(iou, pred_scores, gt_flag, pred_flag,
                                      score_thresholds, iou_threshold):
    """``compute_statistics`` for ALL score thresholds in one pass.

    The reference numba-jits the per-(sample, threshold) greedy matcher
    (evaluation.py:217-263); this port keeps the sequential gt loop (its
    assignment state is inherently ordered) but carries the per-threshold
    assignment state as a (T, num_pred) matrix, so the j scan becomes
    vectorized numpy over all thresholds at once.  Matching semantics are
    bit-identical (oracle-tested against ``compute_statistics``):

    * among eligible flag-0 preds above the IoU gate, the max-IoU one wins
      with first-index tie-break (the reference's strict ``>`` best-chase,
      including the gt_assigned_to_ignore reset interplay);
    * otherwise the FIRST eligible flag-1 (ignore) pred above the gate;
    * fp counts unassigned flag-0 preds above the score threshold.

    Returns (T, 3) [tp, fp, fn].
    """
    num_gt, num_pred = iou.shape
    score_thresholds = np.asarray(score_thresholds)
    T = len(score_thresholds)
    if num_pred == 0:
        fn = np.sum(gt_flag == 0)
        out = np.zeros((T, 3), np.int64)
        out[:, 2] = fn
        return out
    under = pred_scores[None, :] < score_thresholds[:, None]  # (T, P)
    eligible = pred_flag != -1
    flag0 = pred_flag == 0
    flag1 = pred_flag == 1
    assigned = np.zeros((T, num_pred), bool)
    tp = np.zeros(T, np.int64)
    fp = np.zeros(T, np.int64)
    fn = np.zeros(T, np.int64)
    for i in range(num_gt):
        if gt_flag[i] == -1:
            continue
        gate = (iou[i] > iou_threshold) & eligible
        live = ~assigned & ~under  # (T, P)
        m0 = live & (gate & flag0)[None, :]
        m1 = live & (gate & flag1)[None, :]
        any0 = m0.any(axis=1)
        any1 = m1.any(axis=1)
        det0 = np.argmax(np.where(m0, iou[i][None, :], -1.0), axis=1)
        det1 = np.argmax(m1, axis=1)  # first True
        det = np.where(any0, det0, det1)
        detected = any0 | any1
        if gt_flag[i] == 0:
            fn += ~detected
        # assignment applies for every detected row; tp only when the match
        # is a real (flag-0) pred and the gt is flag-0
        rows = np.nonzero(detected)[0]
        assigned[rows, det[rows]] = True
        if gt_flag[i] == 0:
            tp += detected & any0
    fp = np.sum(~assigned & (flag0 & eligible)[None, :] & ~under, axis=1)
    return np.stack([tp, fp, fn], axis=1)


def filter_data(gt_anno, pred_anno, difficulty_mode, difficulty_level,
                class_name, use_superclass):
    """reference evaluation.py:267-324. flags: 0 accept, 1 ignore, -1 reject."""
    num_gt = len(gt_anno["name"])
    gt_flag = np.zeros(num_gt, dtype=np.int64)
    if use_superclass and class_name == "Vehicle":
        reject = np.logical_or(
            gt_anno["name"] == "Pedestrian", gt_anno["name"] == "Cyclist"
        )
    else:
        reject = gt_anno["name"] != class_name
    gt_flag[reject] = -1
    num_pred = len(pred_anno["name"])
    pred_flag = np.zeros(num_pred, dtype=np.int64)
    if use_superclass and class_name == "Vehicle":
        reject = np.logical_or(
            pred_anno["name"] == "Pedestrian", pred_anno["name"] == "Cyclist"
        )
    else:
        reject = pred_anno["name"] != class_name
    pred_flag[reject] = -1

    if difficulty_mode == "Overall":
        gt_flag[overall_filter(gt_anno["boxes_3d"])] = 1
        pred_flag[overall_filter(pred_anno["boxes_3d"])] = 1
    elif difficulty_mode == "Distance":
        gt_flag[distance_filter(gt_anno["boxes_3d"], difficulty_level)] = 1
        pred_flag[distance_filter(pred_anno["boxes_3d"], difficulty_level)] = 1
    elif difficulty_mode == "Overall&Distance":
        gt_flag[overall_distance_filter(gt_anno["boxes_3d"], difficulty_level)] = 1
        pred_flag[
            overall_distance_filter(pred_anno["boxes_3d"], difficulty_level)
        ] = 1
    else:
        raise NotImplementedError
    return gt_flag, pred_flag


def iou3d_kernel(gt_boxes, pred_boxes):
    """reference evaluation.py:388-417: lidar-frame 3D IoU (no heading
    filter)."""
    intersection_2d = rotate_iou_eval(
        gt_boxes[:, [0, 1, 3, 4, 6]], pred_boxes[:, [0, 1, 3, 4, 6]], criterion=2
    )
    gt_max_h = gt_boxes[:, [2]] + gt_boxes[:, [5]] * 0.5
    gt_min_h = gt_boxes[:, [2]] - gt_boxes[:, [5]] * 0.5
    pred_max_h = pred_boxes[:, [2]] + pred_boxes[:, [5]] * 0.5
    pred_min_h = pred_boxes[:, [2]] - pred_boxes[:, [5]] * 0.5
    inter_h = np.minimum(gt_max_h, pred_max_h.T) - np.maximum(gt_min_h, pred_min_h.T)
    inter_h[inter_h <= 0] = 0
    intersection_3d = intersection_2d * inter_h
    gt_vol = gt_boxes[:, [3]] * gt_boxes[:, [4]] * gt_boxes[:, [5]]
    pred_vol = pred_boxes[:, [3]] * pred_boxes[:, [4]] * pred_boxes[:, [5]]
    return intersection_3d / (gt_vol + pred_vol.T - intersection_3d)


def iou3d_kernel_with_heading(gt_boxes, pred_boxes):
    """reference evaluation.py:419-453: iou3d_kernel zeroed when the heading
    difference exceeds 90 degrees."""
    iou3d = iou3d_kernel(gt_boxes, pred_boxes)
    diff_rot = np.abs(gt_boxes[:, [6]] - pred_boxes[:, [6]].T)
    reverse = 2 * np.pi - diff_rot
    diff_rot[diff_rot >= np.pi] = reverse[diff_rot >= np.pi]
    iou3d[diff_rot > np.pi / 2] = 0
    return iou3d


def compute_iou3d(gt_annos, pred_annos, split_parts, with_heading):
    """reference evaluation.py:455-491."""
    gt_num_per_sample = np.stack([len(a["name"]) for a in gt_annos], 0)
    pred_num_per_sample = np.stack([len(a["name"]) for a in pred_annos], 0)
    ious = []
    sample_idx = 0
    for num_part_samples in split_parts:
        gt_part = gt_annos[sample_idx : sample_idx + num_part_samples]
        pred_part = pred_annos[sample_idx : sample_idx + num_part_samples]
        gt_boxes = np.concatenate([a["boxes_3d"] for a in gt_part], 0)
        pred_boxes = np.concatenate(
            [np.asarray(a["boxes_3d"]).reshape(-1, 7) for a in pred_part], 0
        )
        if with_heading:
            iou3d_part = iou3d_kernel_with_heading(gt_boxes, pred_boxes)
        else:
            iou3d_part = iou3d_kernel(gt_boxes, pred_boxes)
        gt_num_idx, pred_num_idx = 0, 0
        for idx in range(num_part_samples):
            gn = gt_num_per_sample[sample_idx + idx]
            pn = pred_num_per_sample[sample_idx + idx]
            ious.append(
                iou3d_part[gt_num_idx : gt_num_idx + gn, pred_num_idx : pred_num_idx + pn]
            )
            gt_num_idx += gn
            pred_num_idx += pn
        sample_idx += num_part_samples
    return ious


def get_evaluation_results(
    gt_annos, pred_annos, classes,
    use_superclass=True, iou_thresholds=None, num_pr_points=50,
    difficulty_mode="Overall&Distance", ap_with_heading=True, num_parts=100,
    print_ok=False,
):
    """reference evaluation.py:26-158."""
    if iou_thresholds is None:
        iou_thresholds = (
            superclass_iou_threshold_dict if use_superclass else iou_threshold_dict
        )
    assert len(gt_annos) == len(pred_annos)
    assert difficulty_mode in ["Overall&Distance", "Overall", "Distance"]
    if use_superclass:
        if ("Car" in classes) or ("Bus" in classes) or ("Truck" in classes):
            assert ("Car" in classes) and ("Bus" in classes) and ("Truck" in classes)
        classes = [c for c in classes if c not in ["Car", "Bus", "Truck"]]
        classes.insert(0, "Vehicle")

    num_samples = len(gt_annos)
    split_parts = compute_split_parts(num_samples, num_parts)
    ious = compute_iou3d(gt_annos, pred_annos, split_parts, with_heading=ap_with_heading)

    num_classes = len(classes)
    if difficulty_mode == "Distance":
        num_difficulties, difficulty_types = 3, ["0-30m", "30-50m", "50m-inf"]
    elif difficulty_mode == "Overall":
        num_difficulties, difficulty_types = 1, ["overall"]
    else:
        num_difficulties = 4
        difficulty_types = ["overall", "0-30m", "30-50m", "50m-inf"]

    precision = np.zeros([num_classes, num_difficulties, num_pr_points + 1])
    recall = np.zeros([num_classes, num_difficulties, num_pr_points + 1])

    for cls_idx, cur_class in enumerate(classes):
        iou_threshold = iou_thresholds[cur_class]
        for diff_idx in range(num_difficulties):
            accum_all_scores, gt_flags, pred_flags = [], [], []
            num_valid_gt = 0
            for sample_idx in range(num_samples):
                gt_anno = gt_annos[sample_idx]
                pred_anno = pred_annos[sample_idx]
                gt_flag, pred_flag = filter_data(
                    gt_anno, pred_anno, difficulty_mode,
                    difficulty_level=diff_idx, class_name=cur_class,
                    use_superclass=use_superclass,
                )
                gt_flags.append(gt_flag)
                pred_flags.append(pred_flag)
                num_valid_gt += int(np.sum(gt_flag == 0))
                accum_all_scores.append(
                    accumulate_scores(
                        ious[sample_idx], pred_anno["score"], gt_flag, pred_flag,
                        iou_threshold=iou_threshold,
                    )
                )
            all_scores = np.concatenate(accum_all_scores, axis=0)
            if num_valid_gt == 0 or len(all_scores) == 0:
                continue
            thresholds = get_thresholds(all_scores, num_valid_gt, num_pr_points)

            confusion = np.zeros([len(thresholds), 3])
            for sample_idx in range(num_samples):
                pred_score = pred_annos[sample_idx]["score"]
                iou = ious[sample_idx]
                gt_flag, pred_flag = gt_flags[sample_idx], pred_flags[sample_idx]
                confusion += compute_statistics_all_thresholds(
                    iou, pred_score, gt_flag, pred_flag, thresholds,
                    iou_threshold=iou_threshold,
                )
            for th_idx in range(len(thresholds)):
                recall[cls_idx, diff_idx, th_idx] = confusion[th_idx, 0] / max(
                    confusion[th_idx, 0] + confusion[th_idx, 2], 1e-9
                )
                precision[cls_idx, diff_idx, th_idx] = confusion[th_idx, 0] / max(
                    confusion[th_idx, 0] + confusion[th_idx, 1], 1e-9
                )
            for th_idx in range(len(thresholds)):
                precision[cls_idx, diff_idx, th_idx] = np.max(
                    precision[cls_idx, diff_idx, th_idx:], axis=-1
                )
                recall[cls_idx, diff_idx, th_idx] = np.max(
                    recall[cls_idx, diff_idx, th_idx:], axis=-1
                )

    AP = 0
    for i in range(1, precision.shape[-1]):
        AP += precision[..., i]
    AP = AP / num_pr_points * 100

    ret_dict = {}
    ret_str = "\n|AP@%-9s|" % (str(num_pr_points))
    for diff_type in difficulty_types:
        ret_str += "%-12s|" % diff_type
    ret_str += "\n"
    for cls_idx, cur_class in enumerate(classes):
        ret_str += "|%-12s|" % cur_class
        for diff_idx in range(num_difficulties):
            key = "AP_" + cur_class + "/" + difficulty_types[diff_idx]
            ap_score = AP[cls_idx, diff_idx]
            ret_dict[key] = ap_score
            ret_str += "%-12.2f|" % ap_score
        ret_str += "\n"
    mAP = np.mean(AP, axis=0)
    ret_str += "|%-12s|" % "mAP"
    for diff_idx in range(num_difficulties):
        key = "AP_mean" + "/" + difficulty_types[diff_idx]
        ret_dict[key] = mAP[diff_idx]
        ret_str += "%-12.2f|" % mAP[diff_idx]
    ret_str += "\n"
    if print_ok:
        print(ret_str)
    return ret_str, ret_dict
