"""Official KITTI object evaluation in numpy, copied from
``pdanet_tpu/datasets/kitti/kitti_object_eval_python/eval.py``
(``pcdet/datasets/kitti/kitti_object_eval_python/eval.py``, itself the
kitti-object-eval-python protocol): class and difficulty cleaning, 41-point
and R40 interpolated AP over the bbox / BEV / 3D / AOS metrics, IoU
thresholds 0.7 / 0.5 / 0.5 (Car / Pedestrian / Cyclist) and the 0.5 / 0.25
table.  The rotated IoU is ``rotate_iou.py``'s, on the g++ host library.
"""

import numpy as np

from .rotate_iou import rotate_iou_eval

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting", "truck"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
NO_DETECTION = -10000000


def get_thresholds(scores, num_gt, num_sample_pts=41):
    """Score thresholds hitting ~41 evenly spaced recall points
    (reference eval.py:9-27)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < (len(scores) - 1) else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (
            i < (len(scores) - 1)
        ):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Class/difficulty filtering (reference eval.py:30-83)."""
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_gt = len(gt_anno["name"])
    num_dt = len(dt_anno["name"])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno["bbox"][i]
        gt_name = str(gt_anno["name"][i]).lower()
        height = bbox[3] - bbox[1]
        valid_class = -1
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        ignore = (
            gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_anno["name"][i]) == "DontCare":
            dc_bboxes.append(bbox)
    for i in range(num_dt):
        valid_class = 1 if str(dt_anno["name"][i]).lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D axis-aligned bbox overlap (reference eval.py:86-118)."""
    N, K = boxes.shape[0], query_boxes.shape[0]
    overlaps = np.zeros((N, K), dtype=np.float64)
    if N == 0 or K == 0:
        return overlaps
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]
    )
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]
    )
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_a = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_b = (query_boxes[:, 2] - query_boxes[:, 0]) * (
        query_boxes[:, 3] - query_boxes[:, 1]
    )
    if criterion == -1:
        denom = area_a[:, None] + area_b[None, :] - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a[:, None], inter.shape)
    else:
        denom = np.broadcast_to(area_b[None, :], inter.shape)
    np.divide(inter, denom, out=overlaps, where=denom > 0)
    return overlaps


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """(N, 5) camera-frame [x, z, l, w, ry] rotated BEV IoU."""
    return rotate_iou_eval(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """(N, 7) camera-frame [x, y, z, l, h, w, ry] 3D IoU
    (reference eval.py:121-157: BEV rotated overlap x y-height overlap;
    boxes are bottom-centered in camera coords)."""
    inter_bev = rotate_iou_eval(
        boxes[:, [0, 2, 3, 5, 6]], qboxes[:, [0, 2, 3, 5, 6]], 2
    )
    ymax = np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
    ymin = np.maximum(
        boxes[:, None, 1] - boxes[:, None, 4], qboxes[None, :, 1] - qboxes[None, :, 4]
    )
    inter_h = np.clip(ymax - ymin, 0, None)
    inter = inter_bev * inter_h
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    if criterion == -1:
        denom = vol_a + vol_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(vol_a, inter.shape)
    else:
        denom = np.broadcast_to(vol_b, inter.shape)
    out = np.zeros_like(inter)
    np.divide(inter, denom, out=out, where=denom > 0)
    return out


def compute_statistics(
    overlaps,
    gt_datas,
    dt_datas,
    ignored_gt,
    ignored_det,
    dc_bboxes,
    metric,
    min_overlap,
    thresh=0,
    compute_fp=False,
    compute_aos=False,
):
    """Single-frame TP/FP/FN matching (reference eval.py:160-264).

    overlaps: (num_dt, num_gt); gt_datas: (num_gt, 5) bbox+alpha;
    dt_datas: (num_dt, 6) bbox+alpha+score.
    """
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [False] * det_size
    if compute_fp:
        for i in range(det_size):
            if dt_scores[i] < thresh:
                ignored_threshold[i] = True
    tp, fp, fn, similarity = 0, 0, 0, 0
    thresholds = np.zeros((gt_size,))
    thresh_idx = 0
    delta = np.zeros((gt_size,))
    delta_idx = 0
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1:
                continue
            if assigned_detection[j]:
                continue
            if ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if not compute_fp and overlap > min_overlap and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif (
                compute_fp
                and overlap > min_overlap
                and (overlap > max_overlap or assigned_ignored_det)
                and ignored_det[j] == 0
            ):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (
                compute_fp
                and overlap > min_overlap
                and valid_detection == NO_DETECTION
                and ignored_det[j] == 1
            ):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if (valid_detection == NO_DETECTION) and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != NO_DETECTION) and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds[thresh_idx] = dt_scores[det_idx]
            thresh_idx += 1
            if compute_aos:
                delta[delta_idx] = gt_alphas[i] - dt_alphas[det_idx]
                delta_idx += 1
            assigned_detection[det_idx] = True

    if compute_fp:
        for i in range(det_size):
            if not (
                assigned_detection[i]
                or ignored_det[i] == -1
                or ignored_det[i] == 1
                or ignored_threshold[i]
            ):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            dc = np.asarray(dc_bboxes).reshape(-1, 4)
            overlaps_dt_dc = image_box_overlap(dt_bboxes, dc, 0)
            for i in range(dc.shape[0]):
                for j in range(det_size):
                    if assigned_detection[j]:
                        continue
                    if ignored_det[j] == -1 or ignored_det[j] == 1:
                        continue
                    if ignored_threshold[j]:
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = np.zeros((fp + delta_idx,))
            for i in range(delta_idx):
                tmp[i + fp] = (1.0 + np.cos(delta[i])) / 2.0
            if tp > 0 or fp > 0:
                similarity = np.sum(tmp)
            else:
                similarity = -1
    return tp, fp, fn, similarity, thresholds[:thresh_idx]


def compute_statistics_all_thresholds(
    overlaps, gt_datas, dt_datas, ignored_gt, ignored_det, dc_bboxes, metric,
    min_overlap, thresholds, compute_aos=False,
):
    """Vectorized twin of ``compute_statistics(compute_fp=True)`` over ALL
    score thresholds at once.

    The reference walks (thresholds x frames) in python — ~2.7M matching
    calls for a full KITTI val run.  Here the gt loop stays python but the
    detection argmax and the assigned/suppressed state are (T, num_dt)
    numpy arrays, one frame pass for all 41 thresholds.

    Returns pr: (T, 4) array of [tp, fp, fn, similarity-sum].
    """
    T = len(thresholds)
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]
    thresholds = np.asarray(thresholds)

    NO_DET = NO_DETECTION
    assigned = np.zeros((T, det_size), dtype=bool)
    under_threshold = dt_scores[None, :] < thresholds[:, None]  # (T, D)
    ign_det = np.asarray(ignored_det)
    base_det_ok = ign_det != -1  # (D,)

    tp = np.zeros(T, dtype=np.int64)
    fp = np.zeros(T, dtype=np.int64)
    fn = np.zeros(T, dtype=np.int64)
    delta_sum = np.zeros(T, dtype=np.float64)
    delta_cnt = np.zeros(T, dtype=np.int64)

    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        ov = overlaps[:, i]  # (D,)
        usable = (
            base_det_ok[None, :]
            & ~assigned
            & ~under_threshold
            & (ov[None, :] > min_overlap)
        )  # (T, D)
        # preferred: real detections (ignored_det == 0) by max overlap
        real = usable & (ign_det == 0)[None, :]
        ov_masked = np.where(real, ov[None, :], -np.inf)
        best_real = np.argmax(ov_masked, axis=1)  # (T,)
        has_real = np.isfinite(ov_masked[np.arange(T), best_real])
        # fallback: ignored detections (ignored_det == 1), first in scan
        # order (the reference keeps the first such j it encounters)
        ignored_ok = usable & (ign_det == 1)[None, :]
        first_ign = np.argmax(ignored_ok, axis=1)
        has_ign = ignored_ok[np.arange(T), first_ign]

        det_idx = np.where(has_real, best_real, first_ign)
        detected = has_real | has_ign
        assigned_to_ignore = ~has_real & has_ign

        if ignored_gt[i] == 0:
            fn += (~detected).astype(np.int64)
        # detected & (gt ignored OR det ignored): just consume the det
        consume_only = detected & (
            (ignored_gt[i] == 1) | assigned_to_ignore
        )
        true_pos = detected & ~consume_only
        tp += true_pos.astype(np.int64)
        if compute_aos:
            d = gt_alphas[i] - dt_alphas[det_idx]
            sim = (1.0 + np.cos(d)) / 2.0
            delta_sum += np.where(true_pos, sim, 0.0)
            delta_cnt += true_pos.astype(np.int64)
        assigned[np.arange(T), det_idx] |= detected

    # false positives: unassigned, real-class, above threshold detections
    fp_mask = (
        ~assigned & (ign_det == 0)[None, :] & ~under_threshold
    )
    fp = fp_mask.sum(axis=1).astype(np.int64)

    # dontcare absorption (metric 0 only)
    if metric == 0 and len(dc_bboxes) > 0:
        dc = np.asarray(dc_bboxes).reshape(-1, 4)
        overlaps_dt_dc = image_box_overlap(dt_bboxes, dc, 0)  # (D, ndc)
        absorbed = np.zeros((T, det_size), dtype=bool)
        hit_dc = (overlaps_dt_dc > min_overlap).any(axis=1)  # (D,)
        absorbed = fp_mask & hit_dc[None, :]
        fp -= absorbed.sum(axis=1).astype(np.int64)

    sim_col = np.zeros(T, dtype=np.float64)
    if compute_aos:
        # reference sums (1+cos)/2 over TPs and zero-pads FPs; rows with
        # tp+fp == 0 contribute -1 (treated as "skip" by the accumulator)
        sim_col = np.where((tp + fp) > 0, delta_sum, -1.0)
    return np.stack(
        [tp.astype(np.float64), fp.astype(np.float64), fn.astype(np.float64),
         sim_col], axis=1,
    )


def _prepare_overlaps(gt_annos, dt_annos, metric):
    """Per-frame (num_dt, num_gt) overlap matrices."""
    overlaps = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            o = image_box_overlap(dt["bbox"], gt["bbox"])
        elif metric == 1:
            loc_g = np.concatenate(
                [gt["location"][:, [0, 2]], gt["dimensions"][:, [0, 2]],
                 gt["rotation_y"][..., None]], axis=1,
            )
            loc_d = np.concatenate(
                [dt["location"][:, [0, 2]], dt["dimensions"][:, [0, 2]],
                 dt["rotation_y"][..., None]], axis=1,
            )
            o = bev_box_overlap(loc_d, loc_g).astype(np.float64)
        elif metric == 2:
            cam_g = np.concatenate(
                [gt["location"], gt["dimensions"], gt["rotation_y"][..., None]],
                axis=1,
            )
            cam_d = np.concatenate(
                [dt["location"], dt["dimensions"], dt["rotation_y"][..., None]],
                axis=1,
            )
            o = d3_box_overlap(cam_d, cam_g).astype(np.float64)
        else:
            raise ValueError(metric)
        overlaps.append(o)
    return overlaps


def eval_class(
    gt_annos, dt_annos, current_classes, difficultys, metric, min_overlaps,
    compute_aos=False, num_parts=None,
):
    """AP over all frames (reference eval.py:448-576).

    Returns dict with precision / aos arrays
    [num_class, num_diff, num_minoverlap, 41].
    """
    assert len(gt_annos) == len(dt_annos)
    num_class = len(current_classes)
    num_diff = len(difficultys)
    num_minoverlap = min_overlaps.shape[0]
    N_SAMPLE_PTS = 41
    precision = np.zeros([num_class, num_diff, num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    overlaps = _prepare_overlaps(gt_annos, dt_annos, metric)

    for m, current_class in enumerate(current_classes):
        for ld, difficulty in enumerate(difficultys):
            # clean per frame
            frame_data = []
            total_num_valid_gt = 0
            for gt, dt in zip(gt_annos, dt_annos):
                rets = clean_data(gt, dt, current_class, difficulty)
                num_valid_gt, ignored_gt, ignored_det, dc_bboxes = rets
                total_num_valid_gt += num_valid_gt
                gt_datas = np.concatenate(
                    [gt["bbox"], gt["alpha"][..., None]], axis=1
                )
                dt_datas = np.concatenate(
                    [dt["bbox"], dt["alpha"][..., None], dt["score"][..., None]],
                    axis=1,
                )
                frame_data.append(
                    (gt_datas, dt_datas, np.array(ignored_gt),
                     np.array(ignored_det), dc_bboxes, num_valid_gt)
                )

            for k in range(num_minoverlap):
                min_overlap = min_overlaps[k, metric, m]
                # pass 1: collect tp scores
                thresholdss = []
                for ov, fd in zip(overlaps, frame_data):
                    tp, fp, fn, sim, th = compute_statistics(
                        ov, fd[0], fd[1], fd[2], fd[3], fd[4], metric,
                        min_overlap=min_overlap, thresh=0.0, compute_fp=False,
                    )
                    thresholdss += th.tolist()
                if total_num_valid_gt == 0 or len(thresholdss) == 0:
                    continue
                thresholds = np.array(
                    get_thresholds(np.array(thresholdss), total_num_valid_gt)
                )
                pr = np.zeros([len(thresholds), 4])
                for ov, fd in zip(overlaps, frame_data):
                    stats = compute_statistics_all_thresholds(
                        ov, fd[0], fd[1], fd[2], fd[3], fd[4], metric,
                        min_overlap=min_overlap, thresholds=thresholds,
                        compute_aos=compute_aos,
                    )
                    pr[:, 0:3] += stats[:, 0:3]
                    sim = stats[:, 3]
                    pr[:, 3] += np.where(sim != -1, sim, 0.0)
                for i in range(len(thresholds)):
                    recall[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, ld, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, ld, k, i] = np.max(
                        precision[m, ld, k, i:], axis=-1
                    )
                    recall[m, ld, k, i] = np.max(recall[m, ld, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, ld, k, i] = np.max(aos[m, ld, k, i:], axis=-1)
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec):
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def print_str(value, *arg, sstream=None):
    import sys
    from io import StringIO

    sstream = StringIO() if sstream is None else sstream
    sstream.truncate(0)
    sstream.seek(0)
    print(value, *arg, file=sstream)
    return sstream.getvalue()


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps, compute_aos=False,
            PR_detail_dict=None):
    difficultys = [0, 1, 2]
    ret = eval_class(
        gt_annos, dt_annos, current_classes, difficultys, 0, min_overlaps,
        compute_aos,
    )
    mAP_bbox = get_mAP(ret["precision"])
    mAP_bbox_R40 = get_mAP_R40(ret["precision"])
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret["orientation"])
        mAP_aos_R40 = get_mAP_R40(ret["orientation"])
    ret = eval_class(
        gt_annos, dt_annos, current_classes, difficultys, 1, min_overlaps,
    )
    mAP_bev = get_mAP(ret["precision"])
    mAP_bev_R40 = get_mAP_R40(ret["precision"])
    ret = eval_class(
        gt_annos, dt_annos, current_classes, difficultys, 2, min_overlaps,
    )
    mAP_3d = get_mAP(ret["precision"])
    mAP_3d_R40 = get_mAP_R40(ret["precision"])
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos, mAP_bbox_R40, mAP_bev_R40,
            mAP_3d_R40, mAP_aos_R40)


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             PR_detail_dict=None):
    overlap_0_7 = np.array(
        [
            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
        ]
    )
    overlap_0_5 = np.array(
        [
            [0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
        ]
    )
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)
    class_to_name = {
        0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
        4: "Person_sitting", 5: "Truck",
    }
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c] if isinstance(c, str) else c for c in current_classes
    ]
    min_overlaps = min_overlaps[:, :, current_classes]
    result = ""
    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break
    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos,
    )

    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        cls_name = class_to_name[curcls]
        for i in range(min_overlaps.shape[0]):
            result += print_str(
                f"{cls_name} AP@"
                + "{:.2f}, {:.2f}, {:.2f}:".format(*min_overlaps[i, :, j])
            )
            result += print_str(
                f"bbox AP:{mAPbbox[j, 0, i]:.4f}, {mAPbbox[j, 1, i]:.4f}, "
                f"{mAPbbox[j, 2, i]:.4f}"
            )
            result += print_str(
                f"bev  AP:{mAPbev[j, 0, i]:.4f}, {mAPbev[j, 1, i]:.4f}, "
                f"{mAPbev[j, 2, i]:.4f}"
            )
            result += print_str(
                f"3d   AP:{mAP3d[j, 0, i]:.4f}, {mAP3d[j, 1, i]:.4f}, "
                f"{mAP3d[j, 2, i]:.4f}"
            )
            result += print_str(
                f"{cls_name} AP_R40@"
                + "{:.2f}, {:.2f}, {:.2f}:".format(*min_overlaps[i, :, j])
            )
            result += print_str(
                f"bbox AP:{mAPbbox_R40[j, 0, i]:.4f}, "
                f"{mAPbbox_R40[j, 1, i]:.4f}, {mAPbbox_R40[j, 2, i]:.4f}"
            )
            result += print_str(
                f"bev  AP:{mAPbev_R40[j, 0, i]:.4f}, "
                f"{mAPbev_R40[j, 1, i]:.4f}, {mAPbev_R40[j, 2, i]:.4f}"
            )
            result += print_str(
                f"3d   AP:{mAP3d_R40[j, 0, i]:.4f}, "
                f"{mAP3d_R40[j, 1, i]:.4f}, {mAP3d_R40[j, 2, i]:.4f}"
            )
            if compute_aos:
                result += print_str(
                    f"aos  AP:{mAPaos_R40[j, 0, i]:.2f}, "
                    f"{mAPaos_R40[j, 1, i]:.2f}, {mAPaos_R40[j, 2, i]:.2f}"
                )
                if i == 0:
                    ret_dict["%s_aos/easy_R40" % cls_name] = mAPaos_R40[j, 0, 0]
                    ret_dict["%s_aos/moderate_R40" % cls_name] = mAPaos_R40[j, 1, 0]
                    ret_dict["%s_aos/hard_R40" % cls_name] = mAPaos_R40[j, 2, 0]
            if i == 0:
                ret_dict["%s_3d/easy_R40" % cls_name] = mAP3d_R40[j, 0, 0]
                ret_dict["%s_3d/moderate_R40" % cls_name] = mAP3d_R40[j, 1, 0]
                ret_dict["%s_3d/hard_R40" % cls_name] = mAP3d_R40[j, 2, 0]
                ret_dict["%s_bev/easy_R40" % cls_name] = mAPbev_R40[j, 0, 0]
                ret_dict["%s_bev/moderate_R40" % cls_name] = mAPbev_R40[j, 1, 0]
                ret_dict["%s_bev/hard_R40" % cls_name] = mAPbev_R40[j, 2, 0]
                ret_dict["%s_image/easy_R40" % cls_name] = mAPbbox_R40[j, 0, 0]
                ret_dict["%s_image/moderate_R40" % cls_name] = mAPbbox_R40[j, 1, 0]
                ret_dict["%s_image/hard_R40" % cls_name] = mAPbbox_R40[j, 2, 0]
    return result, ret_dict
