"""Dataset template, copied from ``pdanet_tpu/datasets/dataset.py``
(``pcdet/datasets/dataset.py``).

``prepare_data`` (reference :102-158) composes PointFeatureEncoder ->
DataAugmentor (train) -> DataProcessor and re-rolls empty-gt frames.
``grid_size`` and ``voxel_size`` are the voxel processor's (None for a
point pipeline), which ``models.build_network`` reads.

``collate_batch`` (reference :160-229) collates frames to dense arrays as
the JAX package does (JAX :145-180): points to ``(B, N, C)``, an exact
stack when every frame has the same count (the ``sample_points`` budget of
the point models) and otherwise zero-padded to the batch's largest, with
``num_points``; the voxel triplet padded to the largest
``max_number_of_voxels`` of the batch (coords with -1, voxels and counts
with 0); gt boxes zero-padded to ``(B, MAX_GT_BOXES, 8)``, the static cap
of the dataset config; CaDDN's 2-D boxes to ``(B, MAX_GT_BOXES, 4)`` and
its ``images`` / ``depth_maps`` zero-padded at the bottom and the right to
the batch's largest frame (JAX :198-215).  KITTI's per-frame ``calib``
and ``image_shape`` stay lists.
"""

from collections import defaultdict
from pathlib import Path

import numpy as np

from ..utils import common_utils
from .augmentor.data_augmentor import DataAugmentor
from .processor.data_processor import DataProcessor
from .processor.point_feature_encoder import PointFeatureEncoder
from .random_draws import rng


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = (
            Path(root_path) if root_path is not None
            else Path(dataset_cfg.DATA_PATH)
        )
        if self.dataset_cfg is None or class_names is None:
            return

        self.point_cloud_range = np.array(
            self.dataset_cfg.POINT_CLOUD_RANGE, dtype=np.float32
        )
        self.point_feature_encoder = PointFeatureEncoder(
            self.dataset_cfg.POINT_FEATURE_ENCODING,
            point_cloud_range=self.point_cloud_range,
        )
        self.data_augmentor = (
            DataAugmentor(
                self.root_path,
                self.dataset_cfg.DATA_AUGMENTOR,
                self.class_names,
                logger=self.logger,
            )
            if self.training
            else None
        )
        self.data_processor = DataProcessor(
            self.dataset_cfg.DATA_PROCESSOR,
            point_cloud_range=self.point_cloud_range,
            training=self.training,
            num_point_features=self.point_feature_encoder.num_point_features,
        )
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.total_epochs = 0
        self._merge_all_iters_to_one_epoch = False

    @property
    def mode(self):
        return "train" if self.training else "test"

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def prepare_data(self, data_dict):
        """reference dataset.py:102-158."""
        if self.training:
            assert "gt_boxes" in data_dict, "gt_boxes should be provided for training"
            gt_boxes_mask = np.array(
                [n in self.class_names for n in data_dict["gt_names"]], dtype=np.bool_
            )
            data_dict = self.data_augmentor.forward(
                data_dict={**data_dict, "gt_boxes_mask": gt_boxes_mask}
            )

        if data_dict.get("gt_boxes", None) is not None:
            selected = common_utils.keep_arrays_by_name(
                data_dict["gt_names"], self.class_names
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            data_dict["gt_names"] = data_dict["gt_names"][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                dtype=np.int32,
            )
            gt_boxes = np.concatenate(
                (
                    data_dict["gt_boxes"],
                    gt_classes.reshape(-1, 1).astype(np.float32),
                ),
                axis=1,
            )
            data_dict["gt_boxes"] = gt_boxes

        if data_dict.get("points", None) is not None:
            data_dict = self.point_feature_encoder.forward(data_dict)

        data_dict = self.data_processor.forward(data_dict=data_dict)

        if self.training and len(data_dict["gt_boxes"]) == 0:
            # re-roll empty-gt frames (reference :152-154)
            new_index = rng().randint(self.__len__())
            return self.__getitem__(new_index)

        data_dict.pop("gt_names", None)
        return data_dict

    def collate_batch(self, batch_list):
        """Dense collate with the config's static gt cap."""
        cap = None
        if self.dataset_cfg is not None:
            cap = self.dataset_cfg.get("MAX_GT_BOXES", None)
        return self.collate_batch_static(batch_list, max_gt_cap=cap)

    @staticmethod
    def collate_batch_static(batch_list, max_gt_cap=None):
        """Dense collate: (B, N, C) points, the (B, V, ...) voxel triplet and
        (B, M, 8) padded gt.

        ``max_gt_cap`` pins the gt axis to a per-config constant, so every
        batch of an epoch has one shape.  Frames with more than
        ``max_gt_cap`` boxes keep the first ``max_gt_cap``."""
        data_dict = defaultdict(list)
        for cur_sample in batch_list:
            for key, val in cur_sample.items():
                data_dict[key].append(val)
        batch_size = len(batch_list)
        ret = {}
        # the voxel budget: every frame padded to the split's cap
        v_max = max(data_dict.pop("max_number_of_voxels", [0]))
        for key, val in data_dict.items():
            if key in ("voxels", "voxel_coords", "voxel_num_points"):
                fill = -1 if key == "voxel_coords" else 0
                ret[key] = np.stack([
                    np.pad(v, [(0, v_max - v.shape[0])] + [(0, 0)] * (v.ndim - 1),
                           constant_values=fill) for v in val], axis=0)
            elif key == "points":
                lens = {v.shape[0] for v in val}
                if len(lens) == 1:
                    # the point models' fixed budget: an exact stack, so no
                    # padding ever reaches FPS or BatchNorm
                    ret[key] = np.stack(val, axis=0).astype(np.float32)
                else:
                    # ragged frames (voxel pipelines sample no budget):
                    # zero-padded; the voxel models read the voxels
                    n_max = max(lens)
                    ret[key] = np.stack([np.pad(v, [(0, n_max - v.shape[0]), (0, 0)])
                                         for v in val], axis=0).astype(np.float32)
                    ret["num_points"] = np.array([v.shape[0] for v in val], dtype=np.int32)
            elif key == "gt_boxes":
                max_gt = max([len(x) for x in val]) if val else 0
                max_gt = max(max_gt, 1)
                if max_gt_cap is not None:
                    max_gt = int(max_gt_cap)
                batch_gt = np.zeros(
                    (batch_size, max_gt, val[0].shape[-1]), dtype=np.float32
                )
                for k in range(batch_size):
                    m = min(len(val[k]), max_gt)
                    batch_gt[k, :m, :] = val[k][:m]
                ret[key] = batch_gt
            elif key == "gt_boxes2d":
                max_gt = max([len(x) for x in val] + [1])
                if max_gt_cap is not None:
                    max_gt = int(max_gt_cap)
                batch_gt = np.zeros((batch_size, max_gt, 4), np.float32)
                for k in range(batch_size):
                    m = min(len(val[k]), max_gt)
                    batch_gt[k, :m, :] = val[k][:m]
                ret[key] = batch_gt
            elif key in ("images", "depth_maps"):
                h_max = max(v.shape[0] for v in val)
                w_max = max(v.shape[1] for v in val)
                ret[key] = np.stack([
                    np.pad(v, [(0, h_max - v.shape[0]), (0, w_max - v.shape[1])]
                           + [(0, 0)] * (v.ndim - 2)) for v in val], axis=0).astype(np.float32)
            elif key in ["frame_id", "metadata", "calib", "image_shape"]:
                ret[key] = val
            else:
                ret[key] = np.stack(val, axis=0)
        ret["batch_size"] = batch_size
        return ret
