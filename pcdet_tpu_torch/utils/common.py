"""Host helpers of the data path, logging and seeding: the port's copies
of `pcdet_tpu.utils.common`'s numpy functions, `create_logger` and
`set_random_seed`."""
import logging
import random

import numpy as np


def keep_arrays_by_name(gt_names, used_classes):
    """Indices (int64) of the names that are in `used_classes`."""
    inds = [i for i, x in enumerate(gt_names) if x in used_classes]
    return np.array(inds, dtype=np.int64)


def mask_points_by_range(points, limit_range):
    """Keep points inside the XY extent of `limit_range` [x0,y0,z0,x1,y1,z1]
    (XY only, inclusive)."""
    mask = (points[:, 0] >= limit_range[0]) & (points[:, 0] <= limit_range[3]) \
        & (points[:, 1] >= limit_range[1]) & (points[:, 1] <= limit_range[4])
    return points[mask]


def pad_or_trim_to(x, target_rows, pad_value=0):
    """Pad (with pad_value) or trim the leading axis of `x` to `target_rows`."""
    n = x.shape[0]
    if n == target_rows:
        return x
    if n > target_rows:
        return x[:target_rows]
    pad_shape = (target_rows - n,) + x.shape[1:]
    pad = np.full(pad_shape, pad_value, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


def rotate_pc_along_z(pc, rot_angle):
    """Rotate, in place, the XY coordinates of `pc` (N, 3+C) by `rot_angle`
    (rad): pc[:, :2] @ [[c, -s], [s, c]]."""
    cosval = np.cos(rot_angle)
    sinval = np.sin(rot_angle)
    rotmat = np.array([[cosval, -sinval], [sinval, cosval]])
    pc[:, 0:2] = np.dot(pc[:, 0:2], rotmat)
    return pc


def enlarge_box3d(boxes3d, extra_width):
    """Grow boxes (N, 7) [x, y, z, w, l, h, r] by `extra_width` on every
    side; z is the bottom center, so it moves down by extra_width."""
    large = np.array(boxes3d, copy=True)
    large[:, 3:6] += extra_width * 2
    large[:, 2] -= extra_width
    return large


def drop_info_with_name(info, name):
    keep = [i for i, x in enumerate(info['name']) if x != name]
    return {k: v[keep] for k, v in info.items()}


def drop_arrays_by_name(gt_names, used_classes):
    """Indices (int64) of the names that are not in `used_classes`."""
    inds = [i for i, x in enumerate(gt_names) if x not in used_classes]
    return np.array(inds, dtype=np.int64)


def limit_period(val, offset=0.5, period=np.pi):
    """val - floor(val / period + offset) * period."""
    return val - np.floor(val / period + offset) * period


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """A console logger, and a file logger where `log_file` is given; rank
    other than 0 logs errors only.  Each call replaces the handlers of the
    call before, so that one process can run the CLIs one after another,
    each into its own log file."""
    logger = logging.getLogger(__name__ + ('_rank%d' % rank))
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    formatter = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    handlers = [logging.StreamHandler()]
    if log_file is not None:
        handlers.append(logging.FileHandler(filename=log_file))
    for handler in handlers:
        handler.setLevel(log_level if rank == 0 else logging.ERROR)
        handler.setFormatter(formatter)
        logger.addHandler(handler)
    return logger


def set_random_seed(seed):
    random.seed(seed)
    np.random.seed(seed)
