"""The BEVSEG fork's capability layer on tensors.

Twin of `pcdet_tpu.experiments` (the reference's pcdet/experiments.py,
rebuilt without its research debris):

  * `between_dataloading_and_feedforward`: the differentiable
    re-voxelization hook.  Under cfg.TORCH_VOXEL_GENERATOR (set by
    USE_PSEUDOLIDAR or INJECT_SEMANTICS) the batch's `points` are voxelized
    on the device by `ops.voxelizer.voxelize_torch` at the TRAIN or TEST
    caps, so the loss reaches the point features through the voxels'
    gather.  A `point_feature_fn` (semantic painting, a pseudo-LiDAR lift)
    plugs in before it.
  * `pseudolidar_points_from_depth`: a depth map lifted into lidar-frame
    points through `utils.calibration.CalibrationTorch`.
  * `BEVSegHead`, `bev_seg_loss`, `BEVSegEvalAccumulator`: the BEV
    segmentation head over RPNV2's `spatial_features_last`, its BCE loss
    with IoU scalars, and the test-time confusion matrix.
  * `training_before_epoch`: the parameter prefixes to freeze.

The hook, the head and the loss are plain torch ops: `pcdet_tpu` computes
them with XLA, not with a Pallas kernel.
"""
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .ops.voxelizer import voxelize_torch
from .parallel import ddp
from .utils.metrics import Evaluator

# the keys the hook reads from a batch
POINT_KEYS = ('points', 'point_mask')


def between_dataloading_and_feedforward(batch, cfg, point_feature_fn=None,
                                        train=None):
    """Re-voxelize a batch's points on their device.

    :param batch: dict with 'points' (B, P, C) and 'point_mask' (B, P) bool
        on the device (and whatever else the model reads)
    :param point_feature_fn: optional fn(points (B, P, C)) -> (B, P, C')
        applied to the points first (semantic injection)
    :param train: TRAIN vs TEST voxel caps; None takes the batch's
        'is_training' entry, then True
    :return: the batch, when cfg.TORCH_VOXEL_GENERATOR is off; else a new
        dict with voxels, num_points_per_voxel, coordinates, voxel_mask,
        voxel_pt_indices_into_original_pt_cloud (`pcdet_tpu`'s keys, under
        the port's name for the points per voxel) and voxel_overflow, all
        from `voxelize_torch`, differentiable in the point features
    :raises ValueError: a batch without 'points' or 'point_mask' under
        TORCH_VOXEL_GENERATOR: the loader's voxels are never used instead
    """
    if not cfg.get('TORCH_VOXEL_GENERATOR', False):
        return batch
    missing = [k for k in POINT_KEYS if k not in batch]
    if missing:
        raise ValueError(
            'TORCH_VOXEL_GENERATOR re-voxelizes the batch\'s points, and the '
            'batch has no %s' % ' or '.join(repr(k) for k in missing))
    points = batch['points']
    if point_feature_fn is not None:
        points = point_feature_fn(points)
    data_cfg = cfg.DATA_CONFIG
    if train is None:
        train = bool(batch.get('is_training', True))
    mode = 'TRAIN' if train else 'TEST'
    vox = voxelize_torch(
        points, batch['point_mask'],
        tuple(data_cfg.VOXEL_GENERATOR.VOXEL_SIZE),
        tuple(data_cfg.POINT_CLOUD_RANGE),
        int(data_cfg.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL),
        int(data_cfg[mode].MAX_NUMBER_OF_VOXELS))
    out = dict(batch)
    for key in ('voxels', 'num_points_per_voxel', 'coordinates',
                'voxel_mask', 'voxel_pt_indices_into_original_pt_cloud',
                'voxel_overflow'):
        out[key] = vox[key]
    return out


def pseudolidar_points_from_depth(depth_map, calib, top_margin_pct=0.35,
                                  bottom_margin_pct=0.15, stride=1):
    """Lift a depth map (H, W) to lidar-frame points (N, 3), differentiably
    in the depths: the rows between the margins, every `stride`-th pixel,
    through `calib.img_to_rect` and `rect_to_lidar` (a
    `utils.calibration.CalibrationTorch`), in row-major pixel order."""
    h, w = depth_map.shape
    top = int(h * top_margin_pct)
    bottom = int(h - h * bottom_margin_pct)
    dev = depth_map.device
    vs = torch.arange(top, bottom, stride, device=dev)
    us = torch.arange(0, w, stride, device=dev)
    vv, uu = torch.meshgrid(vs, us, indexing='ij')
    depth = depth_map[vv, uu]
    pts_rect = calib.img_to_rect(uu.reshape(-1).to(depth_map.dtype),
                                 vv.reshape(-1).to(depth_map.dtype),
                                 depth.reshape(-1))
    return calib.rect_to_lidar(pts_rect)


class BEVSegHead(nn.Module):
    """Conv 3x3 -> ReLU -> conv 3x3 -> ReLU -> conv 1x1 over the detector's
    BEV features, then a bilinear resize to out_size x out_size: per-class
    BEV logits (`pcdet_tpu.experiments.BEVSegHead`).

    Channels-last like the port's RPN: (B, H, W, C) in, (B, out_size,
    out_size, num_classes) out.  It computes in its weights' dtype whatever
    the input's (the RPN's bf16 eval stack included), as flax promotes a
    bf16 input against f32 kernels.  The resize antialiases, as
    `jax.image.resize` does when it shrinks (KITTI's 248 x 216 grid); at
    equal sizes it is the identity.
    """

    def __init__(self, in_channels, num_classes=2, hidden=64, out_size=200):
        super().__init__()
        self.out_size = out_size
        self.conv1 = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, hidden, 3, padding=1)
        self.conv_out = nn.Conv2d(hidden, num_classes, 1)

    def forward(self, bev_features):
        x = bev_features.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = self.conv_out(x)
        x = F.interpolate(x, size=(self.out_size, self.out_size),
                          mode='bilinear', align_corners=False,
                          antialias=True)
        return x.permute(0, 2, 3, 1)


def bev_seg_loss(logits, gt_masks, group=None):
    """BCE-with-logits BEV segmentation loss and per-class IoU scalars
    (`pcdet_tpu.experiments.bev_seg_loss`).  With a process `group` of more
    than one rank the loss is this rank's share of the global batch's mean
    (the sum over the global batch's elements), and the IoU comes from the
    intersections and unions summed over the ranks, in one all-reduce
    (telemetry: no gradient).

    :param logits: (B, H, W, C); :param gt_masks: (B, H, W, C) in {0, 1}
    :return: loss, tb {'bev_loss', 'iou_cls1'.., 'miou'}
    """
    gt = gt_masks.to(logits.dtype)
    ce = (torch.clamp(logits, min=0) - logits * gt
          + torch.log1p(torch.exp(-torch.abs(logits))))
    world = ddp.world_size(group)
    loss = ce.mean() if world == 1 else ce.sum() / (ce.numel() * world)
    preds = logits.detach() > 0
    gt_on = gt > 0.5
    inter = (preds & gt_on).sum(dim=(0, 1, 2))
    union = (preds | gt_on).sum(dim=(0, 1, 2))
    if world > 1:
        inter, union = ddp.all_sum(torch.stack([inter, union]), group)
    iou = inter.to(logits.dtype) / torch.clamp(union, min=1).to(logits.dtype)
    tb = {'bev_loss': loss}
    for c in range(logits.shape[-1]):
        tb['iou_cls%d' % (c + 1)] = iou[c]
    tb['miou'] = iou.mean()
    return loss, tb


def _host(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


class BEVSegEvalAccumulator:
    """Test-time IoU over many batches (the reference's testing_evaluator
    and testing_after_all_iter): one confusion matrix of background and the
    classes, each class's mask added as its own label map."""

    def __init__(self, num_classes=2):
        self.num_classes = num_classes
        self.evaluator = Evaluator(1 + num_classes)

    def add_batch(self, logits, gt_masks):
        """(B, H, W, C) logits and {0, 1} masks, tensors or numpy."""
        preds = (_host(logits) > 0).astype(np.int32)
        gt = _host(gt_masks).astype(np.int32)
        for c in range(self.num_classes):
            gt_c = gt[..., c] * (c + 1)
            pr_c = preds[..., c] * (c + 1)
            self.evaluator.add_batch(gt_c, pr_c)

    def results(self):
        ciou = self.evaluator.class_iou()
        tb = {'test_iou_cls%d' % (c + 1): ciou[c + 1]
              for c in range(self.num_classes)}
        tb['test_miou'] = np.nanmean(ciou[1:])
        return tb


def training_before_epoch(cfg, extra_prefixes=()):
    """The parameter name prefixes to freeze (the reference's
    `seg_model.eval()` and `requires_grad = False` before each epoch when
    an injected semantic network is not trained), then
    MODEL.TRAIN.FREEZE_PARAM_PREFIXES, without repeats; the optimizer leaves
    them out (`train.optimization.build_optimizer_and_schedule`'s
    `frozen_prefixes`)."""
    prefixes = list(extra_prefixes)
    if cfg.get('INJECT_SEMANTICS', False) and not cfg.get(
            'TRAIN_SEMANTIC_NETWORK', False):
        prefixes.append('seg_model')
    train_cfg = cfg.get('MODEL', {}).get('TRAIN', {})
    prefixes += [str(p) for p in train_cfg.get('FREEZE_PARAM_PREFIXES', [])]
    return tuple(dict.fromkeys(prefixes))
