"""ONCE dataset, copied from ``pdanet_tpu/datasets/once/once_dataset.py``
(``pcdet/datasets/once/once_dataset.py``).

Sequence+json infos, roof-lidar .bin reads, gt-database creation, ONCE
prediction dicts, the official ONCE evaluation, and point painting
(``POINT_PAINTING`` + ``SEMSEG_DIR``: camera-semseg scores appended to each
point via numpy bilinear sampling, reference :86-122; the label PNGs read
by ``utils/png.py``, no Pillow).  Infos and db infos stay plain dicts of numpy arrays, so the two
packages read each other's pickles."""

import copy
import json
import pickle
from pathlib import Path

import numpy as np

from ...utils import box_utils
from ...utils.png import read_png
from ..dataset import DatasetTemplate


class ONCEDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names, training=training,
            root_path=root_path, logger=logger,
        )
        self.split = (
            dataset_cfg.DATA_SPLIT["train"] if training else dataset_cfg.DATA_SPLIT["test"]
        )
        assert self.split in ["train", "val", "test", "raw_small", "raw_medium",
                              "raw_large"]
        split_dir = self.root_path / "ImageSets" / (self.split + ".txt")
        self.sample_seq_list = (
            [x.strip() for x in open(split_dir).readlines()]
            if split_dir.exists()
            else None
        )
        self.cam_names = ["cam01", "cam03", "cam05", "cam06", "cam07", "cam08",
                          "cam09"]
        self.once_infos = []
        self.include_once_data(self.split)

    def include_once_data(self, split):
        if self.logger is not None:
            self.logger.info("Loading ONCE dataset")
        once_infos = []
        for info_path in self.dataset_cfg.INFO_PATH[split]:
            info_path = self.root_path / info_path
            if not info_path.exists():
                continue
            with open(info_path, "rb") as f:
                once_infos.extend(pickle.load(f))
        if self.split != "raw":
            once_infos = [i for i in once_infos if "annos" in i]
        self.once_infos.extend(once_infos)
        if self.logger is not None:
            self.logger.info("Total samples for ONCE dataset: %d" % len(once_infos))

    def set_split(self, split):
        super().__init__(
            dataset_cfg=self.dataset_cfg, class_names=self.class_names,
            training=self.training, root_path=self.root_path, logger=self.logger,
        )
        self.split = split
        split_dir = self.root_path / "ImageSets" / (self.split + ".txt")
        self.sample_seq_list = (
            [x.strip() for x in open(split_dir).readlines()]
            if split_dir.exists()
            else None
        )

    def get_lidar(self, sequence_id, frame_id):
        bin_path = (
            self.root_path / "data" / sequence_id / "lidar_roof"
            / ("%s.bin" % frame_id)
        )
        return np.fromfile(str(bin_path), dtype=np.float32).reshape(-1, 4)

    def point_painting(self, points, info):
        """Append per-class semantic scores sampled from camera semseg maps
        (reference once_dataset.py:86-122).

        For every camera, points are projected through ``cam_to_velo``^-1 and
        the intrinsics, then bilinearly sample a one-hot-encoded label map at
        ``<SEMSEG_DIR>/<seq_id>/<cam_name>/<frame_id>_label.png``; cameras are
        applied in ``cam_names`` order, later cameras overwriting earlier ones
        (the reference's ``painted[mask] = proj_scores``).  The reference uses
        torch ``grid_sample`` (align_corners=False, zeros padding); with its
        uv normalization that reduces to bilinear sampling at pixel coordinate
        (u - 0.5, v - 0.5), which is what the numpy path below does.

        ``SEMSEG_DIR`` replaces the reference's hard-coded ``'./'``; classes
        are the reference's fixed [0..5].
        """
        semseg_dir = Path(self.dataset_cfg.get("SEMSEG_DIR", "./"))
        num_classes = 6  # reference used_classes = [0,1,2,3,4,5]
        frame_id, seq_id = str(info["frame_id"]), str(info["sequence_id"])
        painted = np.zeros((points.shape[0], num_classes), dtype=np.float32)
        for cam_name in self.cam_names:
            img_path = semseg_dir / seq_id / cam_name / (frame_id + "_label.png")
            if not img_path.exists():
                continue
            calib_info = info["calib"][cam_name]
            cam_2_velo = np.asarray(calib_info["cam_to_velo"], dtype=np.float64)
            intr = np.asarray(calib_info["cam_intrinsic"], dtype=np.float64)
            cam_intri = np.hstack([intr, np.zeros((3, 1))])
            homo = np.hstack([points[:, :3], np.ones((points.shape[0], 1))])
            pts_cam = homo @ np.linalg.inv(cam_2_velo).T
            mask = pts_cam[:, 2] > 0
            img_pts = pts_cam[mask] @ cam_intri.T
            img_pts = img_pts / img_pts[:, [2]]
            u, v = img_pts[:, 0], img_pts[:, 1]

            seg_map = read_png(img_path)
            H, W = seg_map.shape[:2]
            one_hot = np.zeros((H, W, num_classes), dtype=np.float32)
            for cls_i in range(num_classes):
                one_hot[seg_map == cls_i, cls_i] = 1.0

            # bilinear sample at (u-0.5, v-0.5) with zeros padding
            x, y = u - 0.5, v - 0.5
            x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
            wx, wy = (x - x0)[:, None], (y - y0)[:, None]

            def tap(xi, yi):
                inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                vals = one_hot[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
                return vals * inside[:, None]

            scores = (
                tap(x0, y0) * (1 - wx) * (1 - wy)
                + tap(x0 + 1, y0) * wx * (1 - wy)
                + tap(x0, y0 + 1) * (1 - wx) * wy
                + tap(x0 + 1, y0 + 1) * wx * wy
            )
            painted[mask] = scores.astype(np.float32)
        return np.concatenate([points, painted], axis=1).astype(np.float32)

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.once_infos) * self.total_epochs
        return len(self.once_infos)

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.once_infos)
        info = copy.deepcopy(self.once_infos[index])
        frame_id = info["frame_id"]
        seq_id = info["sequence_id"]
        points = self.get_lidar(seq_id, frame_id)
        if self.dataset_cfg.get("POINT_PAINTING", False):
            points = self.point_painting(points, info)
        input_dict = {"points": points, "frame_id": frame_id}
        if "annos" in info:
            annos = info["annos"]
            input_dict.update(
                {"gt_names": annos["name"], "gt_boxes": annos["boxes_3d"]}
            )
        data_dict = self.prepare_data(data_dict=input_dict)
        data_dict.pop("num_points_in_gt", None)
        return data_dict

    def get_infos(self, num_workers=4, sample_seq_list=None):
        """Sequence json -> per-frame info dicts (reference :159-298)."""
        import concurrent.futures as futures

        root_path = self.root_path
        cam_names = self.cam_names

        def process_single_sequence(seq_idx):
            seq_infos = []
            seq_path = Path(root_path) / "data" / seq_idx
            json_path = seq_path / ("%s.json" % seq_idx)
            with open(json_path, "r") as f:
                info_this_seq = json.load(f)
            meta_info = info_this_seq["meta_info"]
            calib = info_this_seq["calib"]
            frames = info_this_seq["frames"]
            for f_idx, frame in enumerate(frames):
                frame_id = frame["frame_id"]
                prev_id = frames[f_idx - 1]["frame_id"] if f_idx > 0 else None
                next_id = (
                    frames[f_idx + 1]["frame_id"] if f_idx < len(frames) - 1 else None
                )
                pc_path = str(seq_path / "lidar_roof" / ("%s.bin" % frame_id))
                frame_dict = {
                    "sequence_id": seq_idx,
                    "frame_id": frame_id,
                    "timestamp": int(frame_id),
                    "prev_id": prev_id,
                    "next_id": next_id,
                    "meta_info": meta_info,
                    "lidar": pc_path,
                    "pose": np.array(frame["pose"]),
                }
                calib_dict = {}
                for cam_name in cam_names:
                    frame_dict[cam_name] = str(
                        seq_path / cam_name / ("%s.jpg" % frame_id)
                    )
                    calib_dict[cam_name] = {
                        "cam_to_velo": np.array(calib[cam_name]["cam_to_velo"]),
                        "cam_intrinsic": np.array(calib[cam_name]["cam_intrinsic"]),
                        "distortion": np.array(calib[cam_name]["distortion"]),
                    }
                frame_dict["calib"] = calib_dict

                if "annos" in frame:
                    annos = frame["annos"]
                    boxes_3d = np.array(annos["boxes_3d"])
                    if boxes_3d.shape[0] == 0:
                        continue
                    boxes_2d_dict = {
                        c: np.array(annos["boxes_2d"][c]) for c in cam_names
                    }
                    annos_dict = {
                        "name": np.array(annos["names"]),
                        "boxes_3d": boxes_3d,
                        "boxes_2d": boxes_2d_dict,
                    }
                    points = self.get_lidar(seq_idx, frame_id)
                    masks = box_utils.points_in_boxes_cpu(points[:, 0:3], boxes_3d)
                    annos_dict["num_points_in_gt"] = masks.sum(axis=1).astype(
                        np.int32
                    )
                    frame_dict["annos"] = annos_dict
                seq_infos.append(frame_dict)
            return seq_infos

        sample_seq_list = (
            sample_seq_list if sample_seq_list is not None else self.sample_seq_list
        )
        with futures.ThreadPoolExecutor(num_workers) as executor:
            infos = executor.map(process_single_sequence, sample_seq_list)
        all_infos = []
        for info in infos:
            all_infos.extend(info)
        return all_infos

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split="train"):
        database_save_path = Path(self.root_path) / (
            "gt_database" if split == "train" else ("gt_database_%s" % split)
        )
        db_info_save_path = Path(self.root_path) / ("once_dbinfos_%s.pkl" % split)
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        with open(info_path, "rb") as f:
            infos = pickle.load(f)

        for k in range(len(infos)):
            if "annos" not in infos[k]:
                continue
            info = infos[k]
            frame_id = info["frame_id"]
            seq_id = info["sequence_id"]
            points = self.get_lidar(seq_id, frame_id)
            annos = info["annos"]
            names = annos["name"]
            gt_boxes = annos["boxes_3d"]
            num_obj = gt_boxes.shape[0]
            point_indices = box_utils.points_in_boxes_cpu(points[:, 0:3], gt_boxes)
            for i in range(num_obj):
                filename = "%s_%s_%d.bin" % (frame_id, names[i], i)
                filepath = database_save_path / filename
                gt_points = points[point_indices[i] > 0]
                gt_points[:, :3] -= gt_boxes[i, :3]
                with open(filepath, "w") as f:
                    gt_points.tofile(f)
                db_path = str(filepath.relative_to(self.root_path))
                db_info = {
                    "name": names[i], "path": db_path, "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": gt_points.shape[0],
                }
                all_db_infos.setdefault(names[i], []).append(db_info)
        for k, v in all_db_infos.items():
            print("Database %s: %d" % (k, len(v)))
        with open(db_info_save_path, "wb") as f:
            pickle.dump(all_db_infos, f)

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names,
                                  output_path=None):
        def get_template_prediction(num_samples):
            return {
                "name": np.zeros(num_samples),
                "score": np.zeros(num_samples),
                "boxes_3d": np.zeros((num_samples, 7)),
            }

        def generate_single_sample_dict(box_dict):
            pred_scores = np.asarray(box_dict["pred_scores"])
            pred_boxes = np.asarray(box_dict["pred_boxes"])
            pred_labels = np.asarray(box_dict["pred_labels"])
            pred_dict = get_template_prediction(pred_scores.shape[0])
            if pred_scores.shape[0] == 0:
                return pred_dict
            pred_dict["name"] = np.array(class_names)[pred_labels - 1]
            pred_dict["score"] = pred_scores
            pred_dict["boxes_3d"] = pred_boxes
            return pred_dict

        annos = []
        for index, box_dict in enumerate(pred_dicts):
            frame_id = batch_dict["frame_id"][index]
            single_pred_dict = generate_single_sample_dict(box_dict)
            single_pred_dict["frame_id"] = frame_id
            annos.append(single_pred_dict)
            if output_path is not None:
                raise NotImplementedError
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        from .once_eval.evaluation import get_evaluation_results

        eval_det_annos = copy.deepcopy(det_annos)
        eval_gt_annos = [copy.deepcopy(info["annos"]) for info in self.once_infos]
        ap_result_str, ap_dict = get_evaluation_results(
            eval_gt_annos, eval_det_annos, class_names
        )
        return ap_result_str, ap_dict


def create_once_infos(dataset_cfg, class_names, data_path, save_path, workers=4):
    dataset = ONCEDataset(
        dataset_cfg=dataset_cfg, class_names=class_names, root_path=data_path,
        training=False,
    )
    splits = ["train", "val", "test"]
    for split in splits:
        filename = save_path / Path("once_infos_%s.pkl" % split)
        dataset.set_split(split)
        once_infos = dataset.get_infos(num_workers=workers)
        with open(filename, "wb") as f:
            pickle.dump(once_infos, f)
    dataset.set_split("train")
    dataset.create_groundtruth_database(
        save_path / "once_infos_train.pkl", split="train"
    )
