"""Host (numpy) box geometry of the data pipeline and the anchor targets.

The port's copy of `pcdet_tpu.utils.box_np_ops` (the reference's
pcdet/utils/box_utils.py and anchor_target_assigner.py helpers): corners,
range masks, the camera <-> lidar <-> image box transforms, the
point-in-box mask (native, `ops/host_native.points_in_rbboxes`), and the
nearest-box conversion and axis-aligned IoU of the anchor matching.

Box convention everywhere: (x, y, z, w, l, h, rz) in LiDAR coordinates with z
at the *bottom center*; w extends along the box x-axis, l along the box y-axis.
"""
import numpy as np

from ..ops import host_native
from . import common


# ---------------------------------------------------------------------------
# 3D corners
# ---------------------------------------------------------------------------

def boxes3d_to_corners3d_lidar(boxes3d, bottom_center=True):
    """Boxes (N, 7) -> corners (N, 8, 3) in LiDAR coords.

    Corner order matches reference pcdet/utils/box_utils.py:72-115.
    """
    boxes3d = np.asarray(boxes3d, dtype=np.float32)
    n = boxes3d.shape[0]
    w, l, h = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    half_w, half_l = w / 2.0, l / 2.0
    x_sign = np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float32)
    y_sign = np.array([-1, -1, 1, 1, -1, -1, 1, 1], dtype=np.float32)
    x_corners = half_w[:, None] * x_sign[None, :]
    y_corners = half_l[:, None] * y_sign[None, :]
    if bottom_center:
        z_corners = np.zeros((n, 8), dtype=np.float32)
        z_corners[:, 4:8] = h[:, None]
    else:
        z_sign = np.array([-1, -1, -1, -1, 1, 1, 1, 1], dtype=np.float32)
        z_corners = (h / 2.0)[:, None] * z_sign[None, :]

    ry = boxes3d[:, 6]
    cosa, sina = np.cos(ry), np.sin(ry)
    # row-vector convention: corner' = corner @ [[c,-s],[s,c]]
    xr = x_corners * cosa[:, None] + y_corners * sina[:, None]
    yr = -x_corners * sina[:, None] + y_corners * cosa[:, None]

    x = boxes3d[:, 0:1] + xr
    y = boxes3d[:, 1:2] + yr
    z = boxes3d[:, 2:3] + z_corners
    return np.stack([x, y, z], axis=2).astype(np.float32)


def boxes3d_to_corners3d_camera(boxes3d, bottom_center=True):
    """Boxes (N, 7)[x,y,z,l,h,w,ry] in camera coords -> corners (N, 8, 3).

    (reference: pcdet/utils/box_utils.py:118-161)
    """
    boxes3d = np.asarray(boxes3d, dtype=np.float32)
    n = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_sign = np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float32)
    z_sign = np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float32)
    x_corners = (l / 2.0)[:, None] * x_sign[None, :]
    z_corners = (w / 2.0)[:, None] * z_sign[None, :]
    if bottom_center:
        y_corners = np.zeros((n, 8), dtype=np.float32)
        y_corners[:, 4:8] = -h[:, None]
    else:
        y_sign = np.array([1, 1, 1, 1, -1, -1, -1, -1], dtype=np.float32)
        y_corners = (h / 2.0)[:, None] * y_sign[None, :]

    ry = boxes3d[:, 6]
    cosa, sina = np.cos(ry), np.sin(ry)
    # camera frame rotates about y; row-vector @ [[c,0,-s],[0,1,0],[s,0,c]]
    xr = x_corners * cosa[:, None] + z_corners * sina[:, None]
    zr = -x_corners * sina[:, None] + z_corners * cosa[:, None]

    x = boxes3d[:, 0:1] + xr
    y = boxes3d[:, 1:2] + y_corners
    z = boxes3d[:, 2:3] + zr
    return np.stack([x, y, z], axis=2).astype(np.float32)


# ---------------------------------------------------------------------------
# Coordinate-frame box conversion (KITTI camera <-> LiDAR)
# ---------------------------------------------------------------------------

def boxes3d_lidar_to_camera(boxes3d_lidar, calib):
    """(N,7)[x,y,z,w,l,h,r] lidar -> (N,7)[x,y,z,l,h,w,r] rect camera."""
    xyz_lidar = boxes3d_lidar[:, 0:3]
    w, l, h, r = (boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5],
                  boxes3d_lidar[:, 5:6], boxes3d_lidar[:, 6:7])
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    return np.concatenate([xyz_cam, l, h, w, r], axis=-1)


def boxes3d_camera_to_lidar(boxes3d_camera, calib):
    """(N,7)[x,y,z,l,h,w,r] rect camera -> (N,7)[x,y,z,w,l,h,r] lidar."""
    xyz_camera = boxes3d_camera[:, 0:3]
    l, h, w, r = (boxes3d_camera[:, 3:4], boxes3d_camera[:, 4:5],
                  boxes3d_camera[:, 5:6], boxes3d_camera[:, 6:7])
    xyz_lidar = calib.rect_to_lidar(xyz_camera)
    return np.concatenate([xyz_lidar, w, l, h, r], axis=-1)


def boxes3d_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """(N,7) camera boxes -> (N,4)[x1,y1,x2,y2] image boxes."""
    corners3d = boxes3d_to_corners3d_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    corners_in_image = pts_img.reshape(-1, 8, 2)
    min_uv = np.min(corners_in_image, axis=1)
    max_uv = np.max(corners_in_image, axis=1)
    boxes2d = np.concatenate([min_uv, max_uv], axis=1)
    if image_shape is not None:
        boxes2d[:, 0] = np.clip(boxes2d[:, 0], 0, image_shape[1] - 1)
        boxes2d[:, 1] = np.clip(boxes2d[:, 1], 0, image_shape[0] - 1)
        boxes2d[:, 2] = np.clip(boxes2d[:, 2], 0, image_shape[1] - 1)
        boxes2d[:, 3] = np.clip(boxes2d[:, 3], 0, image_shape[0] - 1)
    return boxes2d


# ---------------------------------------------------------------------------
# Range masks / point-in-box
# ---------------------------------------------------------------------------

def mask_boxes_outside_range(boxes, limit_range):
    """True iff ALL 8 corners inside range (reference box_utils.py:213-222)."""
    if boxes.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    corners3d = boxes3d_to_corners3d_lidar(boxes)
    limit_range = np.asarray(limit_range, dtype=np.float32)
    mask = ((corners3d >= limit_range[0:3]) & (corners3d <= limit_range[3:6])).all(axis=2)
    return mask.sum(axis=1) == 8


def points_in_boxes_mask(points, boxes3d):
    """Vectorised point-in-rotated-box test.

    :param points: (P, 3+) xyz...
    :param boxes3d: (N, 7) [x,y,z,w,l,h,rz], z bottom center
    :return: (N, P) bool — mask[i, j] = point j inside box i.

    The reference's `points_in_boxes` (pcdet/ops/roiaware_pool3d): each
    point in each box's canonical frame against the half extents.
    """
    points = np.asarray(points)
    boxes3d = np.asarray(boxes3d, dtype=np.float32).reshape(-1, 7)
    if boxes3d.shape[0] == 0 or points.shape[0] == 0:
        return np.zeros((boxes3d.shape[0], points.shape[0]), dtype=bool)
    return host_native.points_in_rbboxes(points, boxes3d)


def remove_points_in_boxes3d(points, boxes3d):
    """Drop points falling inside any of `boxes3d` (reference box_utils.py:225)."""
    if boxes3d.shape[0] == 0:
        return points
    masks = points_in_boxes_mask(points, boxes3d)
    return points[masks.sum(axis=0) == 0]


# ---------------------------------------------------------------------------
# BEV conversions + axis-aligned IoU (anchor matching path)
# ---------------------------------------------------------------------------

def rbbox2d_to_near_bbox(rbboxes):
    """Rotated (N,5)[x,y,dx,dy,rad] -> nearest axis-aligned (N,4)[x1,y1,x2,y2].

    (reference anchor_target_assigner.py:166-178)
    """
    rots = rbboxes[..., -1]
    rots_0_pi_div_2 = np.abs(common.limit_period(rots, 0.5, np.pi))
    cond = (rots_0_pi_div_2 > np.pi / 4)[..., np.newaxis]
    bboxes_center = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    centers, dims = bboxes_center[:, :2], bboxes_center[:, 2:]
    return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)


def iou_axis_aligned(boxes, query_boxes, eps=0.0):
    """Axis-aligned 2D IoU (N,4)x(K,4)->(N,K).

    Vectorised equivalent of the reference's numba `iou_jit`
    (anchor_target_assigner.py:181-210).
    """
    boxes = np.asarray(boxes, dtype=np.float32)
    query_boxes = np.asarray(query_boxes, dtype=np.float32)
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0] + eps)
              * (query_boxes[:, 3] - query_boxes[:, 1] + eps))        # (K,)
    area_b = ((boxes[:, 2] - boxes[:, 0] + eps)
              * (boxes[:, 3] - boxes[:, 1] + eps))                    # (N,)
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]) + eps)
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]) + eps)
    iw = np.maximum(iw, 0.0)
    ih = np.maximum(ih, 0.0)
    inter = iw * ih
    union = area_b[:, None] + area_q[None, :] - inter
    with np.errstate(divide='ignore', invalid='ignore'):
        iou = np.where(inter > 0, inter / union, 0.0)
    return iou.astype(boxes.dtype)
