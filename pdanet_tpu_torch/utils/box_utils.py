"""Host-side (numpy) box utilities of the input pipeline and the gt
database: the numpy paths of ``pdanet_tpu/utils/box_utils.py``
(``pcdet/utils/box_utils.py``).  The JAX package's g++ host library is not
ported (ROADMAP queue 1); ``tests/test_native.py`` holds it to these numpy
paths.  The KITTI camera conversions come with the KITTI dataset."""

import numpy as np

from .common_utils import rotate_points_along_z_np


def boxes_to_corners_3d(boxes3d):
    """(N, 7) -> (N, 8, 3); corner ordering matches box_utils.py:28-53."""
    template = (
        np.array(
            [
                [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
                [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
            ],
            dtype=np.float32,
        )
        / 2.0
    )
    corners = boxes3d[:, None, 3:6] * template[None, :, :]
    corners = rotate_points_along_z_np(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def enlarge_box3d(boxes3d, extra_width=(0, 0, 0)):
    out = np.array(boxes3d, copy=True)
    out[..., 3:6] += np.asarray(extra_width, dtype=out.dtype)
    return out


def mask_points_by_range(points, limit_range):
    return (
        (points[:, 0] >= limit_range[0])
        & (points[:, 0] <= limit_range[3])
        & (points[:, 1] >= limit_range[1])
        & (points[:, 1] <= limit_range[4])
    )


def mask_boxes_outside_range_numpy(boxes, limit_range, min_num_corners=1):
    """box_utils.py:231-246: keep boxes with >= k corners inside the range."""
    if boxes.shape[1] > 7:
        boxes = boxes[:, 0:7]
    corners = boxes_to_corners_3d(boxes)  # (N, 8, 3)
    inside = ((corners >= np.asarray(limit_range[0:3])) &
              (corners <= np.asarray(limit_range[3:6]))).all(axis=2)
    return inside.sum(axis=1) >= min_num_corners


def remove_points_in_boxes3d(points, boxes3d):
    """box_utils.py:75-89."""
    masks = points_in_boxes_cpu(points[:, 0:3], boxes3d)
    return points[masks.sum(axis=0) == 0]


def points_in_boxes_cpu(points, boxes):
    """(npoints, 3) x (nboxes, 7) -> (nboxes, npoints) 0/1 int32 mask, the
    geometry of roiaware_pool3d's points_in_boxes_cpu
    (roiaware_pool3d_kernel.cu:23-36)."""
    d = points[None, :, :] - boxes[:, None, 0:3]  # (M, N, 3)
    cosa = np.cos(boxes[:, 6])[:, None]
    sina = np.sin(boxes[:, 6])[:, None]
    local_x = d[:, :, 0] * cosa + d[:, :, 1] * sina
    local_y = -d[:, :, 0] * sina + d[:, :, 1] * cosa
    in_z = np.abs(d[:, :, 2]) <= boxes[:, None, 5] / 2.0
    mask = (
        in_z
        & (np.abs(local_x) < boxes[:, None, 3] / 2.0 + 1e-5)
        & (np.abs(local_y) < boxes[:, None, 4] / 2.0 + 1e-5)
    )
    return mask.astype(np.int32)
