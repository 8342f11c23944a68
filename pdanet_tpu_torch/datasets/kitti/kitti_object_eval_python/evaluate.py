"""Offline KITTI evaluation CLI, copied from
``pdanet_tpu/datasets/kitti/kitti_object_eval_python/evaluate.py`` (the
reference's ``kitti_object_eval_python/evaluate.py:1-33``, argparse in place
of fire): re-scores a directory of dumped KITTI-format result txts against a
label directory without re-running inference.

Usage:
    python -m pdanet_tpu_torch.datasets.kitti.kitti_object_eval_python.evaluate \\
        --label_path .../label_2 --result_path .../final_result/data \\
        --label_split_file .../val.txt --current_class Car
"""

import argparse
import os

import numpy as np

from ....utils import object3d_kitti
from .eval import get_official_eval_result


def _read_imageset_file(path):
    with open(path, "r") as f:
        return [int(line) for line in f.readlines() if line.strip()]


def get_label_annos(label_folder, image_ids=None):
    """Read KITTI label/result txts into the eval annos-dict format
    (reference kitti_common.get_label_annos:332-352)."""
    if image_ids is None:
        ids = sorted(
            int(f[:-4]) for f in os.listdir(label_folder)
            if f.endswith(".txt")
        )
    else:
        ids = image_ids
    annos = []
    for idx in ids:
        path = os.path.join(label_folder, "%06d.txt" % idx)
        objs = object3d_kitti.get_objects_from_label(path)
        annos.append({
            "name": np.array([o.cls_type for o in objs]),
            "truncated": np.array([o.truncation for o in objs]),
            "occluded": np.array([o.occlusion for o in objs]),
            "alpha": np.array([o.alpha for o in objs]),
            "bbox": (
                np.stack([o.box2d for o in objs])
                if objs else np.zeros((0, 4))
            ),
            "dimensions": np.array([[o.l, o.h, o.w] for o in objs]).reshape(
                -1, 3
            ),
            "location": (
                np.stack([o.loc for o in objs]) if objs else np.zeros((0, 3))
            ),
            "rotation_y": np.array([o.ry for o in objs]),
            "score": np.array([o.score for o in objs]),
        })
    return annos


def filter_annos_low_score(annos, thresh):
    """reference kitti_common.filter_annos_low_score:191-202."""
    out = []
    for anno in annos:
        keep = anno["score"] > thresh
        out.append({k: v[keep] if v.ndim else v for k, v in anno.items()})
    return out


def evaluate(label_path, result_path, label_split_file, current_class=0,
             score_thresh=-1.0):
    dt_annos = get_label_annos(result_path)
    if score_thresh > 0:
        dt_annos = filter_annos_low_score(dt_annos, score_thresh)
    val_image_ids = _read_imageset_file(label_split_file)
    gt_annos = get_label_annos(label_path, val_image_ids)
    result, ap_dict = get_official_eval_result(
        gt_annos, dt_annos, current_class
    )
    return result, ap_dict


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--label_path", required=True)
    parser.add_argument("--result_path", required=True)
    parser.add_argument("--label_split_file", required=True)
    parser.add_argument(
        "--current_class", default="0",
        help="class index or name (0=Car, 1=Pedestrian, 2=Cyclist), or a "
             "comma-separated list",
    )
    parser.add_argument("--score_thresh", type=float, default=-1.0)
    args = parser.parse_args()
    names = {"car": 0, "pedestrian": 1, "cyclist": 2, "van": 3,
             "person_sitting": 4}
    classes = [
        names.get(c.strip().lower(), None) if not c.strip().isdigit()
        else int(c)
        for c in str(args.current_class).split(",")
    ]
    classes = [c for c in classes if c is not None]
    result, _ = evaluate(
        args.label_path, args.result_path, args.label_split_file,
        classes if len(classes) > 1 else classes[0], args.score_thresh,
    )
    print(result)


if __name__ == "__main__":
    main()
