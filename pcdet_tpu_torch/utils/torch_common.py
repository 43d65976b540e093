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
