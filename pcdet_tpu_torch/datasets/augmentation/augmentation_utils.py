"""Data augmentation on the host: per-object noise with collision retry,
global flip, rotation and scaling.

The port's copy of `pcdet_tpu.datasets.augmentation.augmentation_utils`
(the reference's pcdet/datasets/data_augmentation/augmentation_utils.py):
the same sampling, in the same order, from the same RandomState.  The
per-object noise's first-success search is native (`ops/host_native.
noise_per_box`, csrc/augmentation_native.cpp); `box_collision_test` is the
vectorised numpy one the DB sampler uses.
"""
import numpy as np

from ...ops import host_native
from ...utils import box_np_ops, common


def _ccw(a, b, c):
    """Strict counter-clockwise test, broadcasting; matches reference's
    `(D.y-A.y)*(C.x-A.x) > (C.y-A.y)*(D.x-A.x)` inequality family."""
    return ((c[..., 1] - a[..., 1]) * (b[..., 0] - a[..., 0])
            > (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def box_collision_test(boxes, qboxes):
    """Rotated-rectangle collision matrix from corners.

    :param boxes: (N, 4, 2) corners, :param qboxes: (K, 4, 2)
    :return: (N, K) bool (reference box_collision_test:31-110)
    """
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=bool)
    # standup prefilter
    min_a, max_a = boxes.min(axis=1), boxes.max(axis=1)          # (N, 2)
    min_b, max_b = qboxes.min(axis=1), qboxes.max(axis=1)        # (K, 2)
    iw = (np.minimum(max_a[:, None, 0], max_b[None, :, 0])
          - np.maximum(min_a[:, None, 0], min_b[None, :, 0]))
    ih = (np.minimum(max_a[:, None, 1], max_b[None, :, 1])
          - np.maximum(min_a[:, None, 1], min_b[None, :, 1]))
    standup = (iw > 0) & (ih > 0)                                # (N, K)

    roll = [1, 2, 3, 0]
    a = boxes[:, None, :, None, :]                # (N,1,4,1,2) seg start (box)
    b = boxes[:, roll][:, None, :, None, :]       # seg end
    cpt = qboxes[None, :, None, :, :]             # (1,K,1,4,2) seg start (qbox)
    d = qboxes[:, roll][None, :, None, :, :]      # seg end
    acd = _ccw(a, d, cpt)      # matches reference's acd
    bcd = _ccw(b, d, cpt)
    abc = _ccw(a, b, cpt)
    abd = _ccw(a, b, d)
    crossing = ((acd != bcd) & (abc != abd)).any(axis=(2, 3))    # (N, K)

    def contains_all(outer, inner):
        """True where ALL `inner` corners are strictly inside `outer`.
        cross = vec.y*(ox - ix) - vec.x*(oy - iy) with vec = -(c_k - c_{k+1});
        inside requires cross < 0 for every edge k and corner l."""
        vec = -(outer - outer[:, roll])                          # (N, 4, 2)
        ox = outer[:, None, :, None, 0]                          # (N,1,4,1)
        oy = outer[:, None, :, None, 1]
        ix = inner[None, :, None, :, 0]                          # (1,K,1,4)
        iy = inner[None, :, None, :, 1]
        cross = (vec[:, None, :, None, 1] * (ox - ix)
                 - vec[:, None, :, None, 0] * (oy - iy))
        return (cross < 0).all(axis=(2, 3))                      # (N, K)

    contains = contains_all(boxes, qboxes) | contains_all(qboxes, boxes).T
    return standup & (crossing | contains)


def noise_per_box(boxes, valid_mask, loc_noises, rot_noises):
    """Sequential first-success perturbation search (reference
    noise_per_box), native.

    :param boxes: (N, 5)[x, y, dx, dy, rot]
    :return: (N,) selected try index or -1
    """
    return host_native.noise_per_box(boxes, valid_mask, loc_noises,
                                     rot_noises)


def _select_transform(transform, indices):
    result = np.zeros((transform.shape[0], *transform.shape[2:]),
                      dtype=transform.dtype)
    sel = indices != -1
    result[sel] = transform[np.arange(len(indices))[sel], indices[sel]]
    return result


def points_transform_(points, centers, point_masks, loc_transform,
                      rot_transform, valid_mask):
    """Move points with their (first containing, valid) box.

    :param point_masks: (P, N) bool — point in box (pre-noise)
    (reference points_transform_:218-233, vectorised)
    """
    eligible = point_masks & valid_mask[None, :]
    has_box = eligible.any(axis=1)
    first = np.argmax(eligible, axis=1)
    idx = first[has_box]
    p = points[has_box, :3] - centers[idx]
    rot = rot_transform[idx]
    c, s = np.cos(rot), np.sin(rot)
    x = p[:, 0] * c + p[:, 1] * s
    y = -p[:, 0] * s + p[:, 1] * c
    p = np.stack([x, y, p[:, 2]], axis=-1)
    points[has_box, :3] = p + centers[idx] + loc_transform[idx]
    return points


def noise_per_object_v3_(gt_boxes, points=None, valid_mask=None,
                         rotation_perturb=np.pi / 4, center_noise_std=1.0,
                         num_try=100, rng=np.random):
    """Independently perturb each GT box (+its points) with collision retry.

    (reference noise_per_object_v3_:236-280)
    """
    num_boxes = gt_boxes.shape[0]
    if num_boxes == 0:
        return gt_boxes, points
    if not isinstance(rotation_perturb, (list, tuple, np.ndarray)):
        rotation_perturb = [-rotation_perturb, rotation_perturb]
    if not isinstance(center_noise_std, (list, tuple, np.ndarray)):
        center_noise_std = [center_noise_std] * 3
    if valid_mask is None:
        valid_mask = np.ones((num_boxes,), dtype=np.bool_)
    center_noise_std = np.array(center_noise_std, dtype=gt_boxes.dtype)

    loc_noises = rng.normal(scale=center_noise_std,
                            size=[num_boxes, num_try, 3])
    rot_noises = rng.uniform(rotation_perturb[0], rotation_perturb[1],
                             size=[num_boxes, num_try])

    selected = noise_per_box(gt_boxes[:, [0, 1, 3, 4, 6]], valid_mask,
                             loc_noises, rot_noises)
    loc_transforms = _select_transform(loc_noises, selected)
    rot_transforms = _select_transform(rot_noises, selected)

    gt_boxes_before = gt_boxes.copy()
    gt_boxes[valid_mask, :3] += loc_transforms[valid_mask]
    gt_boxes[valid_mask, 6] += rot_transforms[valid_mask]

    if points is not None:
        masks_dst = box_np_ops.points_in_boxes_mask(points, gt_boxes).T   # (P, N)
        masks_src = box_np_ops.points_in_boxes_mask(points, gt_boxes_before).T
        points = points_transform_(points, gt_boxes_before[:, :3], masks_src,
                                   loc_transforms, rot_transforms, valid_mask)
        keep = ~((masks_dst.sum(axis=1) == 1) & (masks_src.sum(axis=1) == 0))
        points = points[keep]

    return gt_boxes, points


def random_flip(gt_boxes, points, probability=0.5, rng=np.random):
    enable = rng.choice([False, True], replace=False,
                        p=[1 - probability, probability])
    if enable:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6] + np.pi
        points[:, 1] = -points[:, 1]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rotation=np.pi / 4, rng=np.random):
    if not isinstance(rotation, list):
        rotation = [-rotation, rotation]
    noise_rotation = rng.uniform(rotation[0], rotation[1])
    points = common.rotate_pc_along_z(points, noise_rotation)
    gt_boxes = common.rotate_pc_along_z(gt_boxes, noise_rotation)
    gt_boxes[:, 6] += noise_rotation
    return gt_boxes, points


def global_scaling(gt_boxes, points, min_scale=0.95, max_scale=1.05,
                   rng=np.random):
    if max_scale - min_scale < 1e-3:
        return gt_boxes, points
    noise_scale = rng.uniform(min_scale, max_scale)
    points[:, :3] *= noise_scale
    gt_boxes[:, :6] *= noise_scale
    return gt_boxes, points
