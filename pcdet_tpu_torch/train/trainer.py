"""SECOND training, raw scans and boxes to optimizer steps.

    cfg = load_config(SECOND_CFG)                  # tools/cfgs/second.yaml
    trainer = build_trainer(cfg, 'cuda', seed=0, total_steps=100)
    points, mask, gt = make_train_scans(cfg, batch=2)
    batch = trainer.make_batch(torch.as_tensor(points, device='cuda'),
                               torch.as_tensor(mask, device='cuda'), gt)
    tb = trainer.step(batch)        # {'loss', 'rpn_loss_*', 'overflow/*'}

`make_batch` does what the JAX loader and the train step's input side do,
in order: voxelize_torch at the TRAIN voxel cap on the device; one copy of
the coords to the host; the host rulebooks at the train level caps
(`ops/host_books.py`, native builder); the anchor targets per sample
on the host (`models/anchors.AnchorHeadTargets.assign`, as
`pcdet_tpu.datasets.dataset` assigns them); one upload of books and
targets.  `step` is `train_state.TrainState.train_step`: train-mode
forward (masked-BN statistics, the gather-GEMMs), anchor loss, backward
(gather-GEMMs over the mirrored / transposed books, the dW kernels),
adam_onecycle.  `loads` (`ops.sparse.Loads`) picks the kernels of the kw=3
sparse convs: B / E / E′ for the forward and feature gradient, D / D″ / D′
for the weight gradient.
"""
import numpy as np
import torch

from ..datasets.synthetic import make_scene
from ..models.second import SECONDNet
from ..ops import host_books
from ..ops.voxelizer import grid_size, voxelize_torch
from .optimization import AdamOneCycle
from .train_state import TrainState


def make_train_scans(cfg, batch, ring_keep=1.0, num_objects=24):
    """Synthetic scans with their boxes, as `detect.make_scans` makes them
    (scene i from RandomState(i)): points (B, P, 4) f32, point_mask (B, P)
    bool, gt_boxes (B, MAX_GT_BOXES, 8) f32 [x, y, z, w, l, h, ry, class
    id 1..C], zero rows past the scene's boxes."""
    max_points = int(cfg.DATA_CONFIG.MAX_POINTS)
    max_gt = int(cfg.DATA_CONFIG.MAX_GT_BOXES)
    names = list(cfg.CLASS_NAMES)
    points = np.zeros((batch, max_points, 4), np.float32)
    mask = np.zeros((batch, max_points), bool)
    gt = np.zeros((batch, max_gt, 8), np.float32)
    for i in range(batch):
        pts, boxes, box_names = make_scene(
            np.random.RandomState(i), names, num_objects=num_objects,
            ground_mode='rings', pts_per_obj=400, x_range=(3, 68),
            y_range=(-38, 38), ring_keep=ring_keep)
        n = min(len(pts), max_points)
        points[i, :n] = pts[:n]
        mask[i, :n] = True
        m = min(len(boxes), max_gt)
        gt[i, :m, :7] = boxes[:m]
        gt[i, :m, 7] = [names.index(x) + 1 for x in box_names[:m]]
    return points, mask, gt


class Trainer:
    """SECOND, its optimizer and step count, with random weights from
    `seed` (a CPU torch.Generator, so every device gets the same ones) and
    the kw=3 sparse convs' `loads`."""

    def __init__(self, cfg, device, seed=0, total_steps=1,
                 loads=None):
        data_cfg = cfg.DATA_CONFIG
        self.cfg = cfg
        self.voxel_size = tuple(data_cfg.VOXEL_GENERATOR.VOXEL_SIZE)
        self.pc_range = tuple(data_cfg.POINT_CLOUD_RANGE)
        self.max_points_per_voxel = int(
            data_cfg.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL)
        self.max_voxels = int(data_cfg.TRAIN.MAX_NUMBER_OF_VOXELS)
        self.model = SECONDNet(cfg, grid_size(self.voxel_size, self.pc_range),
                               device=device,
                               generator=torch.Generator().manual_seed(seed),
                               loads=loads)
        self.model.train_mode()
        self.device = self.model.device
        params = list(self.model.module.parameters())
        self.state = TrainState(self.model, AdamOneCycle.from_config(
            params, cfg.MODEL.TRAIN.OPTIMIZATION, total_steps))

    def voxelize(self, points, point_mask):
        return voxelize_torch(points, point_mask, self.voxel_size,
                              self.pc_range, self.max_points_per_voxel,
                              self.max_voxels)

    def targets(self, gt_boxes):
        """Anchor targets per sample on the host: box_cls_labels (B, A)
        int32, box_reg_targets (B, A, 7) f32."""
        assign = self.model.anchor_targets.assign
        out = [assign(np.asarray(g)) for g in gt_boxes]
        return (np.stack([t['labels'] for t in out]).astype(np.int32),
                np.stack([t['bbox_targets'] for t in out]).astype(np.float32))

    def make_batch(self, points, point_mask, gt_boxes):
        """(B, P, 4) f32 points and (B, P) bool mask on the trainer's device,
        (B, M, 8) gt boxes with class ids (numpy) -> a batch for `step`."""
        batch = self.voxelize(points, point_mask)
        coords = batch['coordinates'].cpu().numpy()
        flat = self.model.build_books(coords, train=True)
        labels, reg = self.targets(gt_boxes)
        spec = self.model.host_book_spec(coords.shape[1], train=True)
        t = host_books.upload(host_books.wire_arrays(flat, spec) + [
            ('box_cls_labels', labels), ('box_reg_targets', reg)],
            self.device)
        batch['books'] = host_books.decode_books(t, spec, coords.shape[1])
        batch['box_cls_labels'] = t['box_cls_labels']
        batch['box_reg_targets'] = t['box_reg_targets']
        return batch

    def step(self, batch):
        """One optimizer step on `batch`; returns the tb dict (tensors)."""
        return self.state.train_step(batch)


def build_trainer(cfg, device, seed=0, total_steps=1, loads=None):
    """A SECOND trainer (`cfg.MODEL.NAME` SECOND / second_net); the OneCycle
    schedules span `total_steps`; `loads` (None: the backbone's default,
    `sparse.DEFAULT_LOADS`) picks the sparse convs' kernels."""
    if cfg.MODEL.NAME not in ('SECOND', 'second_net'):
        raise ValueError('no training port of model %r' % cfg.MODEL.NAME)
    return Trainer(cfg, device, seed, total_steps, loads)
