"""Training of PointPillar and SECOND, raw scans and boxes to optimizer
steps.

    cfg = load_config()                            # tools/cfgs/pointpillar.yaml
    scans = TrainScans(cfg, num_scans=4, batch_size=2)
    trainer = build_trainer(cfg, 'cuda', seed=0,
                            iters_each_epoch=len(scans), epochs=2)
    points, mask, gt = next(iter(scans))
    batch = trainer.make_batch(torch.as_tensor(points, device='cuda'),
                               torch.as_tensor(mask, device='cuda'), gt)
    tb = trainer.step(batch)        # {'loss', 'rpn_loss_*', 'overflow/*'}

(`train_loop.train_model` runs the epochs, with checkpoints.)  The model
comes from `models.build.build_network` by `cfg.MODEL.NAME`.  A batch comes
from the data loader (`datasets.build_dataloader`: host voxelizer,
augmentation, anchor targets and SECOND's books on the host) through
`upload`, or from raw scans on the device through `make_batch`, which
does what the JAX loader and the train step's input side do, in order:
voxelize_torch at the TRAIN voxel cap on the device; for SECOND, one copy
of the coords to the host and the host rulebooks at the train level caps
(`ops/host_books.py`, native builder); the anchor targets per sample on
the host (`models/anchors.AnchorHeadTargets.assign`, as
`pcdet_tpu.datasets.dataset` assigns them); one upload of books and
targets.  `step` is `train_state.TrainState.train_step`: train-mode
forward (masked-BN statistics; SECOND's gather-GEMMs), anchor loss,
backward (SECOND: gather-GEMMs over the mirrored / transposed books, the
dW kernels), the optimizer of `MODEL.TRAIN.OPTIMIZATION`.  `loads`
(`ops.sparse.Loads`) picks the kernels of SECOND's kw=3 sparse convs: B /
E / E′ for the forward and feature gradient, D / D″ / D′ for the weight
gradient.
"""
import numpy as np
import torch

from ..datasets.synthetic import make_scene
from ..models.build import build_network
from ..ops import host_books
from ..ops.voxelizer import grid_size, voxelize_torch
from .optimization import build_optimizer_and_schedule
from .train_state import TrainState


def make_train_scans(cfg, batch, ring_keep=1.0, num_objects=24):
    """Synthetic scans with their boxes, as `detect.make_scans` makes them
    (scene i from RandomState(i)): points (B, P, 4) f32,
    point_mask (B, P) bool, gt_boxes (B, MAX_GT_BOXES, 8) f32 [x, y, z, w,
    l, h, ry, class id 1..C], zero rows past the scene's boxes."""
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


class TrainScans:
    """`make_train_scans`' scenes 0..num_scans-1 as an epoch's batches of
    numpy (points, mask, gt_boxes), in a seeded order per epoch
    (RandomState(seed + epoch), as `datasets.loader.DataLoader` draws its
    permutation in training), a short last batch dropped.  Raw scans for
    `Trainer.make_batch`: the scenes are made once, with no augmentation,
    and voxelized on the device."""

    def __init__(self, cfg, num_scans, batch_size, seed=0):
        self.points, self.mask, self.gt = make_train_scans(cfg, num_scans)
        self.batch_size = int(batch_size)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.points) // self.batch_size

    def indices(self):
        """The scene order of the current epoch."""
        idx = np.arange(len(self.points))
        np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx[:len(self) * self.batch_size]

    def __iter__(self):
        idx = self.indices()
        for i in range(0, len(idx), self.batch_size):
            b = idx[i:i + self.batch_size]
            yield self.points[b], self.mask[b], self.gt[b]


class Trainer:
    """A model, its optimizer and step count, with random weights from
    `seed` (a CPU torch.Generator, so every device gets the same ones);
    SECOND's kw=3 sparse convs by `loads`.

    :param iters_each_epoch, epochs: the schedules' span (OneCycle over
        their product, step decay at DECAY_STEP_LIST epochs)
    :param frozen_prefixes: parameter name prefixes the optimizer leaves
        out (e.g. 'vfe')
    """

    def __init__(self, cfg, device, seed=0, loads=None, iters_each_epoch=1,
                 epochs=1, frozen_prefixes=()):
        data_cfg = cfg.DATA_CONFIG
        self.cfg = cfg
        self.voxel_size = tuple(data_cfg.VOXEL_GENERATOR.VOXEL_SIZE)
        self.pc_range = tuple(data_cfg.POINT_CLOUD_RANGE)
        self.max_points_per_voxel = int(
            data_cfg.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL)
        self.max_voxels = int(data_cfg.TRAIN.MAX_NUMBER_OF_VOXELS)
        self.model = build_network(
            cfg, grid_size(self.voxel_size, self.pc_range), device=device,
            generator=torch.Generator().manual_seed(seed), loads=loads)
        self.model.train_mode()
        self.device = self.model.device
        optimizer, self.lr_schedule = build_optimizer_and_schedule(
            cfg.MODEL.TRAIN.OPTIMIZATION, iters_each_epoch, epochs,
            frozen_prefixes)
        self.state = TrainState(self.model, optimizer.init(
            self.model.module.named_parameters()))

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
        arrays, spec = [], None
        if hasattr(self.model, 'build_books'):            # SECOND
            coords = batch['coordinates'].cpu().numpy()
            flat = self.model.build_books(coords, train=True)
            spec = self.model.host_book_spec(coords.shape[1], train=True)
            arrays = host_books.wire_arrays(flat, spec)
        labels, reg = self.targets(gt_boxes)
        t = host_books.upload(arrays + [
            ('box_cls_labels', labels), ('box_reg_targets', reg)],
            self.device)
        if spec is not None:
            batch['books'] = host_books.decode_books(t, spec,
                                                     self.max_voxels)
        batch['box_cls_labels'] = t['box_cls_labels']
        batch['box_reg_targets'] = t['box_reg_targets']
        return batch

    def upload(self, batch):
        """A collated loader batch (numpy, `datasets.build_dataloader`'s:
        the host voxelizer's voxels, the anchor targets and, for SECOND,
        the loader's `hb_*` books) -> a batch for `step`, in one upload
        (`host_books.upload_loader_batch`).  The loader's voxels are used as
        they are, never voxelized again."""
        return host_books.upload_loader_batch(batch, self.device, self.model,
                                              train=True)

    def step(self, batch):
        """One optimizer step on `batch`; returns the tb dict (tensors)."""
        return self.state.train_step(batch)


def build_trainer(cfg, device, seed=0, total_steps=None, loads=None,
                  iters_each_epoch=None, epochs=1, frozen_prefixes=()):
    """A trainer of `cfg.MODEL.NAME` (PointPillar, SECOND / second_net).

    The schedules span `iters_each_epoch` x `epochs` steps; given only
    `total_steps`, that is one epoch of `total_steps` iterations (both
    given, they must agree).  `loads` (None: the backbone's default,
    `sparse.DEFAULT_LOADS`) picks SECOND's sparse convs' kernels;
    `frozen_prefixes` are left out of the update."""
    if iters_each_epoch is None:
        total = 1 if total_steps is None else int(total_steps)
        if total % epochs:
            raise ValueError('%d steps do not split into %d epochs'
                             % (total, epochs))
        iters_each_epoch = total // epochs
    elif (total_steps is not None
          and total_steps != iters_each_epoch * epochs):
        raise ValueError('total_steps %d != %d iterations x %d epochs'
                         % (total_steps, iters_each_epoch, epochs))
    return Trainer(cfg, device, seed, loads, iters_each_epoch, epochs,
                   frozen_prefixes)
