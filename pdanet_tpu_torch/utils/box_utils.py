"""Host-side (numpy) box utilities of the input pipeline and the gt
database, copied from ``pdanet_tpu/utils/box_utils.py``
(``pcdet/utils/box_utils.py``).  ``points_in_boxes_cpu`` runs the port's
g++ host library (``native.points_in_boxes``), as the JAX package runs its
own, with the numpy geometry beside it as ``points_in_boxes_plain``.  The
KITTI camera conversions (:92-268 there) serve the KITTI dataset and its
prediction dicts."""

import numpy as np

from .. import native
from .common_utils import limit_period, rotate_points_along_z_np


def in_hull(p, hull):
    from scipy.spatial import Delaunay

    if not isinstance(hull, Delaunay):
        hull = Delaunay(hull)
    return hull.find_simplex(p) >= 0


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
    (roiaware_pool3d_kernel.cu:23-36), by the host library."""
    if not (len(points) and len(boxes)):
        return np.zeros((len(boxes), len(points)), dtype=np.int32)
    return native.points_in_boxes(points, boxes)


def points_in_boxes_plain(points, boxes):
    """The numpy plain version of ``points_in_boxes_cpu``."""
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


# --------------------------------------------------------------------------
# camera <-> lidar conversions (box_utils.py:92-179)
# --------------------------------------------------------------------------


def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib):
    """(N, 7) [x, y, z, l, h, w, r] camera -> (N, 7) [x, y, z, dx, dy, dz,
    heading] lidar (box_utils.py:115-132)."""
    xyz_camera = boxes3d_camera[:, 0:3]
    l, h, w = boxes3d_camera[:, 3:4], boxes3d_camera[:, 4:5], boxes3d_camera[:, 5:6]
    r = boxes3d_camera[:, 6:7]
    xyz_lidar = calib.rect_to_lidar(xyz_camera)
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(r + np.pi / 2)], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib):
    """box_utils.py:135-149."""
    boxes3d_lidar = boxes3d_lidar.copy()
    xyz_lidar = boxes3d_lidar[:, 0:3].copy()
    l, w, h = boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5], boxes3d_lidar[:, 5:6]
    r = boxes3d_lidar[:, 6:7]
    xyz_lidar[:, 2] -= h[:, 0] / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    r = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r], axis=-1)


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """(N, 7) camera boxes -> (N, 4) image 2D boxes (box_utils.py:152-179)."""
    corners3d = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    corners_in_image = pts_img.reshape(-1, 8, 2)
    min_uv = np.min(corners_in_image, axis=1)
    max_uv = np.max(corners_in_image, axis=1)
    boxes2d = np.concatenate([min_uv, max_uv], axis=1)
    if image_shape is not None:
        boxes2d[:, 0] = np.clip(boxes2d[:, 0], a_min=0, a_max=image_shape[1] - 1)
        boxes2d[:, 1] = np.clip(boxes2d[:, 1], a_min=0, a_max=image_shape[0] - 1)
        boxes2d[:, 2] = np.clip(boxes2d[:, 2], a_min=0, a_max=image_shape[1] - 1)
        boxes2d[:, 3] = np.clip(boxes2d[:, 3], a_min=0, a_max=image_shape[0] - 1)
    return boxes2d


def boxes3d_to_corners3d_kitti_camera(boxes3d, bottom_center=True):
    """(N, 7) [x, y, z, l, h, w, r] camera-frame corners
    (box_utils.py:182-212)."""
    boxes_num = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_corners = np.array(
        [l / 2.0, l / 2.0, -l / 2.0, -l / 2.0, l / 2.0, l / 2.0, -l / 2.0, -l / 2.0]
    ).T
    z_corners = np.array(
        [w / 2.0, -w / 2.0, -w / 2.0, w / 2.0, w / 2.0, -w / 2.0, -w / 2.0, w / 2.0]
    ).T
    if bottom_center:
        y_corners = np.zeros((boxes_num, 8), dtype=np.float32)
        y_corners[:, 4:8] = -h.reshape(boxes_num, 1).repeat(4, axis=1)
    else:
        y_corners = np.array(
            [h / 2.0, h / 2.0, h / 2.0, h / 2.0, -h / 2.0, -h / 2.0, -h / 2.0, -h / 2.0]
        ).T

    ry = boxes3d[:, 6]
    zeros, ones = np.zeros(ry.size), np.ones(ry.size)
    rot_list = np.array(
        [
            [np.cos(ry), zeros, -np.sin(ry)],
            [zeros, ones, zeros],
            [np.sin(ry), zeros, np.cos(ry)],
        ]
    )  # (3, 3, N)
    R_list = np.transpose(rot_list, (2, 0, 1))
    temp_corners = np.concatenate(
        (
            x_corners.reshape(-1, 8, 1),
            y_corners.reshape(-1, 8, 1),
            z_corners.reshape(-1, 8, 1),
        ),
        axis=2,
    )
    rotated = np.matmul(temp_corners, R_list)
    x_loc, y_loc, z_loc = boxes3d[:, 0], boxes3d[:, 1], boxes3d[:, 2]
    x = x_loc.reshape(-1, 1) + rotated[:, :, 0]
    y = y_loc.reshape(-1, 1) + rotated[:, :, 1]
    z = z_loc.reshape(-1, 1) + rotated[:, :, 2]
    return np.concatenate(
        (x.reshape(-1, 8, 1), y.reshape(-1, 8, 1), z.reshape(-1, 8, 1)), axis=2
    ).astype(np.float32)


def boxes3d_lidar_to_aligned_bev_boxes(boxes3d):
    """(N, 7+) -> (N, 4) axis-aligned xmin,ymin,xmax,ymax (box_utils.py:255-268)."""
    rot_angle = np.abs(limit_period(boxes3d[:, 6], offset=0.5, period=np.pi))
    choose_dims = np.where(
        rot_angle[:, None] < np.pi / 4, boxes3d[:, [3, 4]], boxes3d[:, [4, 3]]
    )
    return np.concatenate(
        [boxes3d[:, 0:2] - choose_dims / 2, boxes3d[:, 0:2] + choose_dims / 2], axis=-1
    )
