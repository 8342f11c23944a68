"""Host data processor (numpy), copied from
``pdanet_tpu/datasets/processor/data_processor.py``:
``mask_points_and_boxes_outside_range`` (reference :78-91),
``shuffle_points`` (:93-103), ``sample_points`` (:187-217, the near/far
fixed budget that gives a point model its static point count),
``sort_points`` (an x-sort with no reference counterpart), the voxel grid:
``transform_points_to_voxels`` (JAX :156-235) through the port's g++ host
library (``native.voxelize``), as the JAX package runs its own, with the
numpy grid hash beside it as ``voxelize_plain``, ``calculate_grid_size``
and ``transform_points_to_voxels_placeholder``; ``sample_points_by_voxels``
(JAX :237-266: one point a voxel, then the budget) and CaDDN's
``downsample_depth_map`` (JAX :129-144: a block mean).
"""

from functools import partial

import numpy as np

from ... import native
from ...utils import box_utils
from ..random_draws import rng

PROCESSORS = ("mask_points_and_boxes_outside_range", "shuffle_points", "sort_points",
              "sample_points", "calculate_grid_size", "transform_points_to_voxels_placeholder",
              "transform_points_to_voxels", "sample_points_by_voxels", "downsample_depth_map")


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training,
                 num_point_features):
        self.point_cloud_range = np.asarray(point_cloud_range, dtype=np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = "train" if training else "test"
        self.grid_size = self.voxel_size = None
        self.data_processor_queue = []
        for cur_cfg in processor_configs:
            if cur_cfg.NAME not in PROCESSORS:
                raise ValueError(f"data processor {cur_cfg.NAME}: the JAX package has "
                                 f"{', '.join(PROCESSORS)}")
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
            shuffle_idx = rng().permutation(points.shape[0])
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
                near_idxs_choice = rng().choice(
                    near_idxs, num_points - len(far_idxs_choice), replace=False
                )
                choice = (
                    np.concatenate((near_idxs_choice, far_idxs_choice), axis=0)
                    if len(far_idxs_choice) > 0
                    else near_idxs_choice
                )
            else:
                choice = np.arange(0, len(points), dtype=np.int32)
                choice = rng().choice(choice, num_points, replace=False)
            rng().shuffle(choice)
        else:
            choice = np.arange(0, len(points), dtype=np.int32)
            if num_points > len(points):
                extra_choice = rng().choice(choice, num_points - len(points))
                choice = np.concatenate((choice, extra_choice), axis=0)
            rng().shuffle(choice)
        data_dict["points"] = points[choice]
        return data_dict

    def _set_grid(self, config):
        grid_size = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) \
            / np.array(config.VOXEL_SIZE)
        self.grid_size = np.round(grid_size).astype(np.int64)
        self.voxel_size = config.VOXEL_SIZE

    def calculate_grid_size(self, data_dict=None, config=None):
        if data_dict is None:
            self._set_grid(config)
            return partial(self.calculate_grid_size, config=config)
        return data_dict

    def transform_points_to_voxels_placeholder(self, data_dict=None, config=None):
        if data_dict is None:
            self._set_grid(config)
            return partial(self.transform_points_to_voxels_placeholder, config=config)
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None):
        """Voxelization by the host library's grid hash: voxels in order of
        their first point, points in scan order within a voxel, at most
        ``MAX_POINTS_PER_VOXEL`` points a voxel and ``MAX_NUMBER_OF_VOXELS``
        voxels (of this split) a frame -- what the reference's spconv CPU
        voxelizer gives (data_processor.py:115-143).  Adds ``voxels``
        (V, P, C), ``voxel_coords`` (V, 3) zyx, ``voxel_num_points`` (V,)
        and the split's cap ``max_number_of_voxels``, which the collate
        pads to."""
        if data_dict is None:
            self._set_grid(config)
            return partial(self.transform_points_to_voxels, config=config)

        max_voxels = int(config.MAX_NUMBER_OF_VOXELS[self.mode])
        voxels, voxel_coords, voxel_num_points = native.voxelize(
            data_dict["points"], self.point_cloud_range,
            np.asarray(config.VOXEL_SIZE, dtype=np.float32), self.grid_size,
            int(config.MAX_POINTS_PER_VOXEL), max_voxels)
        data_dict["voxels"] = voxels
        data_dict["voxel_coords"] = voxel_coords
        data_dict["voxel_num_points"] = voxel_num_points
        data_dict["max_number_of_voxels"] = max_voxels
        return data_dict

    def sample_points_by_voxels(self, data_dict=None, config=None):
        """Voxelize, keep one point a voxel (``SAMPLE_TYPE`` ``raw``: its
        first in scan order; ``mean_vfe``: the mean of its kept points),
        then the fixed budget of ``sample_points`` (reference :145-185, the
        Waymo / nuScenes IA-SSD entry).  ``NUM_POINTS`` -1 keeps the cloud
        as it is (dynamic voxelization)."""
        if data_dict is None:
            self._set_grid(config)
            return partial(self.sample_points_by_voxels, config=config)
        if config.NUM_POINTS[self.mode] == -1:
            return data_dict
        data_dict = self.transform_points_to_voxels(data_dict, config=config)
        voxels = data_dict.pop("voxels")
        voxel_num_points = data_dict.pop("voxel_num_points")
        data_dict.pop("voxel_coords")
        data_dict.pop("max_number_of_voxels", None)
        if config.get("SAMPLE_TYPE", "raw") == "mean_vfe":
            data_dict["points"] = (voxels.sum(axis=1)
                                   / voxel_num_points[:, None]).astype(np.float32)
        else:
            data_dict["points"] = voxels[:, 0]
        return self.sample_points(data_dict, config=config)

    def downsample_depth_map(self, data_dict=None, config=None):
        """The depth map's block mean over ``DOWNSAMPLE_FACTOR`` squares,
        zero-padded to a multiple first (reference :227-236, skimage's
        ``downscale_local_mean`` with cval 0)."""
        if data_dict is None:
            self.depth_downsample_factor = config.DOWNSAMPLE_FACTOR
            return partial(self.downsample_depth_map, config=config)
        f = int(self.depth_downsample_factor)
        dm = data_dict["depth_maps"]
        H, W = dm.shape
        ph, pw = (-H) % f, (-W) % f
        if ph or pw:
            dm = np.pad(dm, ((0, ph), (0, pw)))
        data_dict["depth_maps"] = dm.reshape(
            (H + ph) // f, f, (W + pw) // f, f).mean(axis=(1, 3)).astype(np.float32)
        return data_dict

    def forward(self, data_dict):
        for cur_processor in self.data_processor_queue:
            data_dict = cur_processor(data_dict=data_dict)
        return data_dict


def voxelize_plain(points, pcr, voxel_size, grid, max_pts, max_voxels):
    """The numpy plain version of ``native.voxelize`` (the JAX package's
    numpy grid hash): the same outputs, bit for bit."""
    coords = np.floor((points[:, 0:3] - pcr[0:3]) / voxel_size).astype(np.int64)
    inside = ((coords >= 0).all(axis=1) & (coords[:, 0] < grid[0])
              & (coords[:, 1] < grid[1]) & (coords[:, 2] < grid[2]))
    points = points[inside]
    coords = coords[inside]
    # voxel id in zyx scan order (reference coords are (z, y, x))
    vid = (coords[:, 2] * grid[1] + coords[:, 1]) * grid[0] + coords[:, 0]
    _, first_idx, inverse = np.unique(vid, return_index=True, return_inverse=True)
    order = np.argsort(np.argsort(first_idx))  # rank by first appearance
    slot = order[inverse]
    num_voxels = min(len(first_idx), max_voxels)

    # rank of each point within its voxel, in scan order
    order_pts = np.argsort(slot, kind="stable")
    sorted_slot = slot[order_pts]
    boundaries = np.concatenate([[0], np.cumsum(np.bincount(sorted_slot))])
    rank = np.empty(len(points), dtype=np.int64)
    rank[order_pts] = np.arange(len(points)) - boundaries[sorted_slot]

    keep = (slot < num_voxels) & (rank < max_pts)
    voxels = np.zeros((num_voxels, max_pts, points.shape[1]), dtype=np.float32)
    voxels[slot[keep], rank[keep]] = points[keep]
    counts = np.bincount(slot, minlength=num_voxels)[:num_voxels]
    # first_idx is ordered by voxel id; reorder to first-appearance slots
    voxel_coords = coords[first_idx[np.argsort(order)]][:num_voxels][:, ::-1]
    return (voxels, voxel_coords.astype(np.int32),
            np.minimum(counts, max_pts).astype(np.int32))
