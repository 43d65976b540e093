"""Tensor math helpers — twins of `pcdet_tpu.utils.jnp_common`."""
import math

import torch


def limit_period(val, offset=0.5, period=math.pi):
    return val - torch.floor(val / period + offset) * period


def boxes3d_to_bev_corner_format(boxes3d):
    """(..., 7) -> (..., 5)[x1,y1,x2,y2,ry] (see box_np_ops)."""
    cu, cv = boxes3d[..., 0], boxes3d[..., 1]
    half_l, half_w = boxes3d[..., 4] / 2.0, boxes3d[..., 3] / 2.0
    return torch.stack([cu - half_w, cv - half_l, cu + half_w, cv + half_l,
                        boxes3d[..., 6]], dim=-1)


def rotate_points_along_z(points, angles):
    """Rotate batched points (..., P, 3+C) by angles (...,), the row-vector
    convention [x, y] @ [[c, -s], [s, c]]."""
    cosa = torch.cos(angles)[..., None, None]
    sina = torch.sin(angles)[..., None, None]
    x, y = points[..., 0:1], points[..., 1:2]
    xr = x * cosa + y * sina
    yr = -x * sina + y * cosa
    return torch.cat([xr, yr, points[..., 2:]], dim=-1)


def boxes3d_to_corners3d_lidar(boxes3d, bottom_center=True):
    """Boxes (..., 7) [x, y, z, w, l, h, ry] -> corners (..., 8, 3)."""
    w, l, h = boxes3d[..., 3], boxes3d[..., 4], boxes3d[..., 5]
    x_sign = boxes3d.new_tensor([1, -1, -1, 1, 1, -1, -1, 1])
    y_sign = boxes3d.new_tensor([-1, -1, 1, 1, -1, -1, 1, 1])
    x_c = (w / 2)[..., None] * x_sign
    y_c = (l / 2)[..., None] * y_sign
    if bottom_center:
        z_c = h[..., None] * boxes3d.new_tensor([0, 0, 0, 0, 1, 1, 1, 1])
    else:
        z_c = (h / 2)[..., None] * boxes3d.new_tensor(
            [-1, -1, -1, -1, 1, 1, 1, 1])
    ry = boxes3d[..., 6]
    cosa, sina = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    xr = x_c * cosa + y_c * sina
    yr = -x_c * sina + y_c * cosa
    return torch.stack([boxes3d[..., 0:1] + xr, boxes3d[..., 1:2] + yr,
                        boxes3d[..., 2:3] + z_c], dim=-1)


def points_in_boxes(points, boxes3d):
    """(P, 3+) points, (N, 7) boxes [x, y, z (bottom), w, l, h, ry] -> (N, P)
    bool: each point in each box's canonical frame within the half extents
    in x, y and between the bottom and the top in z (`pcdet_tpu.utils.
    jnp_common.points_in_boxes`, the twin of `box_np_ops.
    points_in_boxes_mask`)."""
    shift = points[None, :, :3] - boxes3d[:, None, 0:3]
    cosa = torch.cos(-boxes3d[:, 6])[:, None]
    sina = torch.sin(-boxes3d[:, 6])[:, None]
    lx = shift[..., 0] * cosa + shift[..., 1] * sina
    ly = -shift[..., 0] * sina + shift[..., 1] * cosa
    lz = shift[..., 2]
    return ((torch.abs(lx) <= boxes3d[:, 3:4] / 2)
            & (torch.abs(ly) <= boxes3d[:, 4:5] / 2)
            & (lz >= 0) & (lz <= boxes3d[:, 5:6]))
