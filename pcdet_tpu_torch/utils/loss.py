"""Loss primitives on tensors — twins of `pcdet_tpu.utils.loss`.

Parity targets: reference pcdet/utils/loss_utils.py, through the JAX
package's functions of the same names.  Every function is elementwise over
fixed shapes; weights carry the masking.
"""
import math

import torch
import torch.nn.functional as F

from . import torch_common
from .torch_common import limit_period


def sigmoid_cross_entropy_with_logits(logits, labels):
    """Numerically stable per-element sigmoid CE (loss_utils.py:117-125)."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def sigmoid_focal_loss(logits, targets, weights, gamma=2.0, alpha=0.25):
    """Sigmoid focal CE.

    :param logits: (..., A, C); :param targets: (..., A, C) one-hot
    :param weights: (..., A) or (..., A, C)
    :return: (..., A, C) per-entry loss (loss_utils.py:56-114)
    """
    if weights.dim() == targets.dim() - 1:
        weights = weights[..., None]
    ce = sigmoid_cross_entropy_with_logits(logits, targets)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    modulating = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    alpha_w = (targets * alpha + (1 - targets) * (1 - alpha)
               if alpha is not None else 1.0)
    return modulating * alpha_w * ce * weights


def weighted_smooth_l1(preds, targets, weights=None, sigma=3.0,
                       code_weights=None):
    """Smooth-L1 in the reference's sigma form (loss_utils.py:128-175):
    0.5 (sigma x)^2 where |x| <= 1 / sigma^2, else |x| - 0.5 / sigma^2.

    :param preds, targets: (..., A, code); :param weights: (..., A) or None
    :return: (..., A, code)
    """
    diff = preds - targets
    if code_weights is not None:
        diff = torch.as_tensor(code_weights, dtype=diff.dtype,
                               device=diff.device) * diff
    abs_diff = torch.abs(diff)
    lt = (abs_diff <= 1.0 / (sigma ** 2)).to(abs_diff.dtype)
    loss = (lt * 0.5 * torch.square(abs_diff * sigma)
            + (abs_diff - 0.5 / (sigma ** 2)) * (1.0 - lt))
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_softmax_ce(logits, one_hot_targets, weights, logit_scale=1.0):
    """Per-row softmax CE against the argmax of one-hot targets
    (loss_utils.py:178-220)."""
    logits = logits / logit_scale
    labels = torch.argmax(one_hot_targets, dim=-1)
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return ce * weights


def huber_loss(error, delta):
    abs_error = torch.abs(error)
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def corner_loss_lidar(pred_bbox3d, gt_bbox3d):
    """Huber loss on the corner distances, the least over the GT heading
    and its flip (loss_utils.py:231-249).

    :param pred_bbox3d: (N, 7), :param gt_bbox3d: (N, 7)
    :return: (N,)

    At a zero corner distance the two packages' norms differ in their
    gradient: `torch.linalg.norm` gives 0 there, `jnp.linalg.norm` NaN (x
    / 0).  Neither is met in training: a prediction lands exactly on a GT
    corner with probability 0.
    """
    pred_corners = torch_common.boxes3d_to_corners3d_lidar(pred_bbox3d)
    gt_corners = torch_common.boxes3d_to_corners3d_lidar(gt_bbox3d)
    gt_flip = torch.cat([gt_bbox3d[:, :6], gt_bbox3d[:, 6:7] + math.pi,
                         gt_bbox3d[:, 7:]], dim=1)
    gt_corners_flip = torch_common.boxes3d_to_corners3d_lidar(gt_flip)
    dist = torch.minimum(
        torch.linalg.norm(pred_corners - gt_corners, dim=2),
        torch.linalg.norm(pred_corners - gt_corners_flip, dim=2))
    return huber_loss(dist, delta=1.0).mean(dim=1)


def add_sin_difference(boxes1, boxes2, dim=6):
    """Heading residuals as sin(a - b) = sin a cos b - cos a sin b, split
    between the two sides (rpn_head.py:104-111)."""
    rad_pred = (torch.sin(boxes1[..., dim:dim + 1])
                * torch.cos(boxes2[..., dim:dim + 1]))
    rad_tg = (torch.cos(boxes1[..., dim:dim + 1])
              * torch.sin(boxes2[..., dim:dim + 1]))
    b1 = torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]], -1)
    b2 = torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]], -1)
    return b1, b2


def get_direction_target(anchors, reg_targets, dir_offset=0.0, num_bins=2,
                         one_hot=True):
    """Direction-bin targets from heading residuals (rpn_head.py:113-127).

    :param anchors: (B, A, 7); :param reg_targets: (B, A, 7)
    """
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = limit_period(rot_gt - dir_offset, 0, 2 * math.pi)
    dir_cls = torch.floor(offset_rot / (2 * math.pi / num_bins)).to(
        torch.int64)
    dir_cls = torch.clamp(dir_cls, 0, num_bins - 1)
    if one_hot:
        return F.one_hot(dir_cls, num_bins).to(anchors.dtype)
    return dir_cls.to(torch.int32)
