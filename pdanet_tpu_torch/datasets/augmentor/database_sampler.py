"""GT-database paste-in sampler, copied from
``pdanet_tpu/datasets/augmentor/database_sampler.py``
(``pcdet/datasets/augmentor/database_sampler.py``: class-balanced top-up,
rotated-BEV collision rejection, road-plane height fix, point carve-out).

Host numpy only; the SharedArray /dev/shm cache is dropped (the page cache
covers the small per-object .bin files)."""

import pickle

import numpy as np

from ...utils import box_utils
from ...utils.iou3d_np import boxes_bev_iou_cpu
from ..random_draws import own_generator


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.sampler_cfg = sampler_cfg
        self.logger = logger
        self.db_infos = {c: [] for c in class_names}

        for db_info_path in sampler_cfg.DB_INFO_PATH:
            path = self.root_path.resolve() / db_info_path
            with open(str(path), "rb") as f:
                infos = pickle.load(f)
                for cur_class in class_names:
                    self.db_infos[cur_class].extend(infos.get(cur_class, []))

        for func_name, val in sampler_cfg.PREPARE.items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.sample_groups = {}
        self.sample_class_num = {}
        self.limit_whole_scene = sampler_cfg.get("LIMIT_WHOLE_SCENE", False)
        for x in sampler_cfg.SAMPLE_GROUPS:
            class_name, sample_num = x.split(":")
            if class_name not in class_names:
                continue
            self.sample_class_num[class_name] = sample_num
            self.sample_groups[class_name] = {
                "sample_num": sample_num,
                "pointer": len(self.db_infos[class_name]),
                "indices": np.arange(len(self.db_infos[class_name])),
            }

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("logger", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        new_db_infos = {}
        for key, dinfos in db_infos.items():
            pre_len = len(dinfos)
            new_db_infos[key] = [
                info for info in dinfos if info["difficulty"] not in removed_difficulty
            ]
            if self.logger is not None:
                self.logger.info(
                    "Database filter by difficulty %s: %d => %d"
                    % (key, pre_len, len(new_db_infos[key]))
                )
        return new_db_infos

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(":")
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                filtered = [
                    info
                    for info in db_infos[name]
                    if info["num_points_in_gt"] >= min_num
                ]
                if self.logger is not None:
                    self.logger.info(
                        "Database filter by min points %s: %d => %d"
                        % (name, len(db_infos[name]), len(filtered))
                    )
                db_infos[name] = filtered
        return db_infos

    def sample_with_fixed_number(self, class_name, sample_group):
        """Round-robin over a shuffled epoch of db entries
        (database_sampler.py:118-134); under a sample's own generator
        (``random_draws.sample_generator``), a fresh draw of that
        generator's instead."""
        sample_num = int(sample_group["sample_num"])
        rs = own_generator()
        if rs is not None:
            # a sample of a threaded loader draws its own entries: the
            # round-robin's shared pointer would depend on the threads' order
            picks = rs.permutation(len(self.db_infos[class_name]))[:sample_num]
            return [self.db_infos[class_name][idx] for idx in picks]
        pointer, indices = sample_group["pointer"], sample_group["indices"]
        if pointer >= len(self.db_infos[class_name]):
            indices = np.random.permutation(len(self.db_infos[class_name]))
            pointer = 0
        sampled = [
            self.db_infos[class_name][idx]
            for idx in indices[pointer : pointer + sample_num]
        ]
        sample_group["pointer"] = pointer + sample_num
        sample_group["indices"] = indices
        return sampled

    @staticmethod
    def put_boxes_on_road_planes(gt_boxes, road_planes, calib):
        """KITTI road-plane z snap (database_sampler.py:136-154)."""
        a, b, c, d = road_planes
        center_cam = calib.lidar_to_rect(gt_boxes[:, 0:3])
        cur_height_cam = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
        center_cam[:, 1] = cur_height_cam
        cur_lidar_height = calib.rect_to_lidar(center_cam)[:, 2]
        mv_height = gt_boxes[:, 2] - gt_boxes[:, 5] / 2 - cur_lidar_height
        gt_boxes[:, 2] -= mv_height
        return gt_boxes, mv_height

    def add_sampled_boxes_to_scene(
        self, data_dict, sampled_gt_boxes, total_valid_sampled_dict
    ):
        gt_boxes_mask = data_dict["gt_boxes_mask"]
        gt_boxes = data_dict["gt_boxes"][gt_boxes_mask]
        gt_names = data_dict["gt_names"][gt_boxes_mask]
        points = data_dict["points"]
        mv_height = None
        if self.sampler_cfg.get("USE_ROAD_PLANE", False):
            sampled_gt_boxes, mv_height = self.put_boxes_on_road_planes(
                sampled_gt_boxes, data_dict["road_plane"], data_dict["calib"]
            )
            data_dict.pop("calib")
            data_dict.pop("road_plane")

        obj_points_list = []
        for idx, info in enumerate(total_valid_sampled_dict):
            file_path = self.root_path / info["path"]
            obj_points = np.fromfile(str(file_path), dtype=np.float32).reshape(
                [-1, self.sampler_cfg.NUM_POINT_FEATURES]
            )
            obj_points[:, :3] += info["box3d_lidar"][:3]
            if mv_height is not None:
                obj_points[:, 2] -= mv_height[idx]
            obj_points_list.append(obj_points)

        obj_points = np.concatenate(obj_points_list, axis=0)
        sampled_gt_names = np.array([x["name"] for x in total_valid_sampled_dict])

        large_sampled = box_utils.enlarge_box3d(
            sampled_gt_boxes[:, 0:7], extra_width=self.sampler_cfg.REMOVE_EXTRA_WIDTH
        )
        points = box_utils.remove_points_in_boxes3d(points, large_sampled)
        points = np.concatenate([obj_points, points], axis=0)
        data_dict["gt_boxes"] = np.concatenate([gt_boxes, sampled_gt_boxes], axis=0)
        data_dict["gt_names"] = np.concatenate([gt_names, sampled_gt_names], axis=0)
        data_dict["points"] = points
        return data_dict

    def __call__(self, data_dict):
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"].astype(str)
        existed_boxes = gt_boxes
        total_valid_sampled_dict = []
        for class_name, sample_group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = np.sum(class_name == gt_names)
                sample_group["sample_num"] = str(
                    int(self.sample_class_num[class_name]) - num_gt
                )
            if int(sample_group["sample_num"]) > 0:
                sampled_dict = self.sample_with_fixed_number(class_name, sample_group)
                if len(sampled_dict) == 0:
                    # empty db for this class (the reference assumes all
                    # classes are present and would crash; skip instead)
                    continue
                sampled_boxes = np.stack(
                    [x["box3d_lidar"] for x in sampled_dict], axis=0
                ).astype(np.float32)

                iou1 = boxes_bev_iou_cpu(sampled_boxes[:, 0:7], existed_boxes[:, 0:7])
                iou2 = boxes_bev_iou_cpu(sampled_boxes[:, 0:7], sampled_boxes[:, 0:7])
                iou2[range(len(sampled_boxes)), range(len(sampled_boxes))] = 0
                iou1 = iou1 if iou1.shape[1] > 0 else iou2
                valid_mask = ((iou1.max(axis=1) + iou2.max(axis=1)) == 0).nonzero()[0]
                valid_sampled_dict = [sampled_dict[x] for x in valid_mask]
                valid_sampled_boxes = sampled_boxes[valid_mask]

                existed_boxes = np.concatenate(
                    (existed_boxes, valid_sampled_boxes), axis=0
                )
                total_valid_sampled_dict.extend(valid_sampled_dict)

        sampled_gt_boxes = existed_boxes[gt_boxes.shape[0] :, :]
        if len(total_valid_sampled_dict) > 0:
            data_dict = self.add_sampled_boxes_to_scene(
                data_dict, sampled_gt_boxes, total_valid_sampled_dict
            )
        data_dict.pop("gt_boxes_mask")
        return data_dict
