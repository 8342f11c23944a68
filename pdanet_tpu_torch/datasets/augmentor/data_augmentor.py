"""Augmentation queue, copied from
``pdanet_tpu/datasets/augmentor/data_augmentor.py``
(``pcdet/datasets/augmentor/data_augmentor.py``): gt_sampling, the world
flip / rotation / scaling with their ENABLE_PROB gates, the world and local
translations, the local rotation and scaling, the world and local frustum
dropouts, the SE-SSD pyramid augmentation and CaDDN's horizontal image
flip.

``random_world_frustum_dropout`` drops the names, the gt-sampling mask and
the 2-D boxes of the boxes it drops, with them: the JAX package drops the
boxes alone, so that its ``forward`` raises on the frame's mask, or its
names and boxes disagree in length without one (ROADMAP queue 3)."""

from functools import partial

import numpy as np

from ...utils import common_utils
from . import augmentor_utils, database_sampler

AUGMENTORS = ("gt_sampling", "random_world_flip", "random_world_rotation",
              "random_world_scaling", "random_world_translation", "random_local_translation",
              "random_local_rotation", "random_local_scaling", "random_world_frustum_dropout",
              "random_local_frustum_dropout", "random_local_pyramid_aug", "random_image_flip")
PER_BOX_KEYS = ("gt_names", "gt_boxes_mask", "gt_boxes2d")  # rows that go with gt_boxes


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.data_augmentor_queue = []
        aug_config_list = (
            augmentor_configs
            if isinstance(augmentor_configs, list)
            else augmentor_configs.AUG_CONFIG_LIST
        )
        for cur_cfg in aug_config_list:
            if not isinstance(augmentor_configs, list):
                if cur_cfg.NAME in augmentor_configs.DISABLE_AUG_LIST:
                    continue
            if cur_cfg.NAME not in AUGMENTORS:
                raise ValueError(f"augmentor {cur_cfg.NAME}: the JAX package has "
                                 f"{', '.join(AUGMENTORS)}")
            cur_augmentor = getattr(self, cur_cfg.NAME)(config=cur_cfg)
            self.data_augmentor_queue.append(cur_augmentor)

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("logger", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)

    def gt_sampling(self, config=None):
        return database_sampler.DataBaseSampler(
            root_path=self.root_path,
            sampler_cfg=config,
            class_names=self.class_names,
            logger=self.logger,
        )

    def random_world_flip(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_flip, config=config)
        enable_prob = config.get("ENABLE_PROB", 0.5)
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        for cur_axis in config["ALONG_AXIS_LIST"]:
            assert cur_axis in ["x", "y"]
            gt_boxes, points = getattr(
                augmentor_utils, "random_flip_along_%s" % cur_axis
            )(gt_boxes, points, enable_prob=enable_prob)
        data_dict["gt_boxes"] = gt_boxes
        data_dict["points"] = points
        return data_dict

    def random_world_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_rotation, config=config)
        enable_prob = config.get("ENABLE_PROB", 1.0)
        rot_range = config["WORLD_ROT_ANGLE"]
        if not isinstance(rot_range, list):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points = augmentor_utils.global_rotation(
            data_dict["gt_boxes"], data_dict["points"], rot_range=rot_range,
            enable_prob=enable_prob,
        )
        data_dict["gt_boxes"] = gt_boxes
        data_dict["points"] = points
        return data_dict

    def random_world_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_scaling, config=config)
        enable_prob = config.get("ENABLE_PROB", 1.0)
        gt_boxes, points = augmentor_utils.global_scaling(
            data_dict["gt_boxes"], data_dict["points"],
            config["WORLD_SCALE_RANGE"], enable_prob=enable_prob,
        )
        data_dict["gt_boxes"] = gt_boxes
        data_dict["points"] = points
        return data_dict

    def random_image_flip(self, data_dict=None, config=None):
        """CaDDN's camera-input flip (reference data_augmentor.py:123-140):
        the image, the depth map and the 3-D boxes, mirrored through the
        image, on one coin a frame."""
        if data_dict is None:
            return partial(self.random_image_flip, config=config)
        for cur_axis in config["ALONG_AXIS_LIST"]:
            assert cur_axis in ["horizontal"]
            images, depth_maps, gt_boxes = augmentor_utils.random_image_flip_horizontal(
                data_dict["images"], data_dict["depth_maps"], data_dict["gt_boxes"],
                data_dict["calib"])
        data_dict["images"] = images
        data_dict["depth_maps"] = depth_maps
        data_dict["gt_boxes"] = gt_boxes
        return data_dict

    def random_world_translation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_translation, config=config)
        # the reference reads NOISE_TRANSLATE_STD (data_augmentor.py:142);
        # pointpillar_newaugs.yaml ships WORLD_TRANSLATION_RANGE instead,
        # read as a (min, max) whose half-width is the std (JAX :108-115)
        if "NOISE_TRANSLATE_STD" in config:
            std = config["NOISE_TRANSLATE_STD"]
        else:
            lo, hi = config["WORLD_TRANSLATION_RANGE"]
            std = (hi - lo) / 2.0
        if std == 0:
            return data_dict
        gt_boxes, points = augmentor_utils.random_world_translation(
            data_dict["gt_boxes"], data_dict["points"], std, config["ALONG_AXIS_LIST"])
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_translation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_translation, config=config)
        gt_boxes, points = augmentor_utils.random_local_translation(
            data_dict["gt_boxes"], data_dict["points"], config["LOCAL_TRANSLATION_RANGE"],
            config["ALONG_AXIS_LIST"])
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_rotation, config=config)
        rot_range = config["LOCAL_ROT_ANGLE"]
        if not isinstance(rot_range, list):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points = augmentor_utils.local_rotation(
            data_dict["gt_boxes"], data_dict["points"], rot_range)
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_scaling, config=config)
        gt_boxes, points = augmentor_utils.local_scaling(
            data_dict["gt_boxes"], data_dict["points"], config["LOCAL_SCALE_RANGE"])
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_world_frustum_dropout(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_frustum_dropout, config=config)
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        for direction in config["DIRECTION"]:
            gt_boxes, points, keep = augmentor_utils.global_frustum_dropout(
                gt_boxes, points, config["INTENSITY_RANGE"], direction)
            for key in PER_BOX_KEYS:
                if key in data_dict:
                    data_dict[key] = data_dict[key][keep]
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_frustum_dropout(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_frustum_dropout, config=config)
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        for direction in config["DIRECTION"]:
            gt_boxes, points = augmentor_utils.local_frustum_dropout(
                gt_boxes, points, config["INTENSITY_RANGE"], direction)
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_pyramid_aug(self, data_dict=None, config=None):
        """SE-SSD pyramid dropout, then sparsify, then swap (reference
        data_augmentor.py:246-267)."""
        if data_dict is None:
            return partial(self.random_local_pyramid_aug, config=config)
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        gt_boxes, points, pyramids = augmentor_utils.local_pyramid_dropout(
            gt_boxes, points, config["DROP_PROB"])
        gt_boxes, points, pyramids = augmentor_utils.local_pyramid_sparsify(
            gt_boxes, points, config["SPARSIFY_PROB"], config["SPARSIFY_MAX_NUM"], pyramids)
        gt_boxes, points = augmentor_utils.local_pyramid_swap(
            gt_boxes, points, config["SWAP_PROB"], config["SWAP_MAX_NUM"], pyramids)
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def forward(self, data_dict):
        for cur_augmentor in self.data_augmentor_queue:
            data_dict = cur_augmentor(data_dict=data_dict)
        data_dict["gt_boxes"][:, 6] = common_utils.limit_period(
            data_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi
        )
        if "calib" in data_dict:
            data_dict.pop("calib")
        if "road_plane" in data_dict:
            data_dict.pop("road_plane")
        if "gt_boxes_mask" in data_dict:
            gt_boxes_mask = data_dict["gt_boxes_mask"]
            data_dict["gt_boxes"] = data_dict["gt_boxes"][gt_boxes_mask]
            data_dict["gt_names"] = data_dict["gt_names"][gt_boxes_mask]
            if "gt_boxes2d" in data_dict:
                data_dict["gt_boxes2d"] = data_dict["gt_boxes2d"][
                    gt_boxes_mask
                ]
            data_dict.pop("gt_boxes_mask")
        return data_dict
