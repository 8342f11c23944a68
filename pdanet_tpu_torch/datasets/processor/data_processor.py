"""Host data processor (numpy): the point processors of
``pdanet_tpu/datasets/processor/data_processor.py`` that the PDA-SSD yamls
name -- ``mask_points_and_boxes_outside_range`` (reference :78-91),
``shuffle_points`` (:93-103), ``sample_points`` (:187-217, the near/far
fixed budget that gives the model its static point count) and
``sort_points`` (an x-sort with no reference counterpart).  The voxel and
depth-map processors belong to the zoo's other families and raise.
"""

from functools import partial

import numpy as np

from ...utils import box_utils

POINT_PROCESSORS = ("mask_points_and_boxes_outside_range", "shuffle_points",
                    "sort_points", "sample_points")


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training,
                 num_point_features):
        self.point_cloud_range = np.asarray(point_cloud_range, dtype=np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = "train" if training else "test"
        self.data_processor_queue = []
        for cur_cfg in processor_configs:
            if cur_cfg.NAME not in POINT_PROCESSORS:
                raise NotImplementedError(
                    f"data processor {cur_cfg.NAME} is ROADMAP queue 1 item 9")
            self.data_processor_queue.append(
                getattr(self, cur_cfg.NAME)(config=cur_cfg)
            )

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.mask_points_and_boxes_outside_range, config=config)
        if data_dict.get("points", None) is not None:
            mask = box_utils.mask_points_by_range(
                data_dict["points"], self.point_cloud_range
            )
            data_dict["points"] = data_dict["points"][mask]
        if (
            data_dict.get("gt_boxes", None) is not None
            and config.REMOVE_OUTSIDE_BOXES
            and self.training
        ):
            mask = box_utils.mask_boxes_outside_range_numpy(
                data_dict["gt_boxes"],
                self.point_cloud_range,
                min_num_corners=config.get("min_num_corners", 1),
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][mask]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config.SHUFFLE_ENABLED[self.mode]:
            points = data_dict["points"]
            shuffle_idx = np.random.permutation(points.shape[0])
            data_dict["points"] = points[shuffle_idx]
        return data_dict

    def sort_points(self, data_dict=None, config=None):
        """Spatially order the cloud (sort by x), with no reference
        counterpart.  Point order is semantically free (the reference
        itself randomizes it via ``shuffle_points``); a sorted order keeps
        the ball query's support tiles spatially tight, so its exact tile
        skip fires.  Runs after shuffle/sample so it is the final order.
        The stable sort keeps duplicate-coordinate points in prior order."""
        if data_dict is None:
            return partial(self.sort_points, config=config)
        enabled = config.get("ENABLED", {"train": True, "test": True})
        if enabled[self.mode]:
            points = data_dict["points"]
            order = np.argsort(points[:, 0], kind="stable")
            data_dict["points"] = points[order]
        return data_dict

    def sample_points(self, data_dict=None, config=None):
        """Fixed point budget with near(<40 m)/far split (reference
        :187-217) — pad-by-duplicate when short.  This is what makes every
        device tensor static-shape."""
        if data_dict is None:
            return partial(self.sample_points, config=config)
        num_points = config.NUM_POINTS[self.mode]
        if num_points == -1:
            return data_dict
        points = data_dict["points"]
        if num_points < len(points):
            pts_depth = np.linalg.norm(points[:, 0:3], axis=1)
            pts_near_flag = pts_depth < 40.0
            far_idxs_choice = np.where(pts_near_flag == 0)[0]
            near_idxs = np.where(pts_near_flag == 1)[0]
            if num_points > len(far_idxs_choice):
                near_idxs_choice = np.random.choice(
                    near_idxs, num_points - len(far_idxs_choice), replace=False
                )
                choice = (
                    np.concatenate((near_idxs_choice, far_idxs_choice), axis=0)
                    if len(far_idxs_choice) > 0
                    else near_idxs_choice
                )
            else:
                choice = np.arange(0, len(points), dtype=np.int32)
                choice = np.random.choice(choice, num_points, replace=False)
            np.random.shuffle(choice)
        else:
            choice = np.arange(0, len(points), dtype=np.int32)
            if num_points > len(points):
                extra_choice = np.random.choice(choice, num_points - len(points))
                choice = np.concatenate((choice, extra_choice), axis=0)
            np.random.shuffle(choice)
        data_dict["points"] = points[choice]
        return data_dict

    def forward(self, data_dict):
        for cur_processor in self.data_processor_queue:
            data_dict = cur_processor(data_dict=data_dict)
        return data_dict
