"""Numpy helpers of the evaluation's data path: the port's copies of
`pcdet_tpu.utils.common`'s `keep_arrays_by_name`, `mask_points_by_range`
and `pad_or_trim_to`."""
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
