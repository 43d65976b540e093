"""Training of PointPillar, SECOND and Part-A² (-fc), raw scans and boxes to
optimizer steps.

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
voxelize_torch at the TRAIN voxel cap on the device; for SECOND and
Part-A², one copy of the coords to the host and the host rulebooks at the
train level caps (`ops/host_books.py`, native builder; under
PCDET_HOST_BOOKS=0 the books are built on the device from the device's
coords, `host_books.build_books_device`); the anchor
targets per sample on the host (`models/anchors.AnchorHeadTargets.assign`,
as `pcdet_tpu.datasets.dataset` assigns them) and the model's own host
targets (`host_targets`; Part-A²: the GT boxes and the per-voxel
segmentation and part targets); one upload of books and targets.  `step` is
`train_state.TrainState.train_step`: train-mode forward (masked-BN
statistics; the sparse convs' gather-GEMMs; Part-A²'s proposals, RoI
sampler, pool and RCNN), the loss, backward (gather-GEMMs over the
mirrored / transposed books, the dW kernels), the optimizer of
`MODEL.TRAIN.OPTIMIZATION`.  `loads` (`ops.sparse.Loads`) picks the
kernels of the kw=3 sparse convs: B / E / E′ for the forward and feature
gradient, D / D″ / D′ for the weight gradient.  A model that draws at
random in training (`draws`; Part-A²: the sampler and dropout) draws from
the trainer's `generator`, a torch.Generator on the device seeded from
`seed`, whose state a checkpoint carries.  Data-parallel training
(`process_group`, one process a card: `parallel.ddp`) gives each rank its
share of the global batch; the weights are the same on every rank (the
CPU generator from `seed`), the device generator is seeded from `seed` and
the rank.  `bn_groups` > 1 takes the BatchNorm statistics per block of the
batch (JAX's BN_GROUPS: what W ranks with their own statistics compute,
in one process); `sync_bn` takes them over the group's ranks.  Under the fork's
cfg.TORCH_VOXEL_GENERATOR (USE_PSEUDOLIDAR, INJECT_SEMANTICS) a batch
carries its points instead of voxels and the step's hook voxelizes them at
the TRAIN caps, so the loss reaches the points (`make_batch(...,
point_feature_fn=)` paints them first; `step(batch, inputs=(depth,))`
keeps the loss's gradient by a tensor the points came from).
"""
import numpy as np
import torch

from ..datasets.synthetic import make_scene
from ..experiments import between_dataloading_and_feedforward
from ..models.build import build_network
from ..models.layers import set_batch_norm
from ..ops import host_books
from ..parallel import ddp
from ..ops.voxelizer import grid_size, voxelize_torch
from ..utils.profiler import span
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
    `seed` (a CPU torch.Generator, so every device and rank gets the same
    ones); the kw=3 sparse convs by `loads`.  A model that draws (`draws`;
    Part-A²'s sampler and dropout) draws from `generator`, a generator on
    the device seeded from `seed` and the rank (`ddp.rank_seed`).

    :param iters_each_epoch, epochs: the schedules' span (OneCycle over
        their product, step decay at DECAY_STEP_LIST epochs)
    :param frozen_prefixes: parameter name prefixes the optimizer leaves
        out (e.g. 'vfe'), besides the model's own `frozen_prefixes()`
        (Part-A²'s stage 1 under MODEL.RPN.PARAMS_FIXED)
    :param bn_groups: BatchNorm statistics per this many blocks of the
        batch (`layers.set_batch_norm`)
    :param process_group: the ranks that share the global batch (None:
        this process alone); `device` is this rank's
    :param sync_bn: BatchNorm statistics over the ranks of the group
    """

    def __init__(self, cfg, device, seed=0, loads=None, iters_each_epoch=1,
                 epochs=1, frozen_prefixes=(), bn_groups=1,
                 process_group=None, sync_bn=False):
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
        self.process_group = process_group
        self.model.process_group = process_group
        set_batch_norm(self.model.module, bn_groups,
                       process_group if sync_bn else None)
        self.generator = None
        if self.model.draws:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(ddp.rank_seed(
                seed, ddp.rank(process_group)))
            self.model.set_generator(self.generator)
        frozen_prefixes = (tuple(frozen_prefixes)
                           + tuple(self.model.frozen_prefixes()))
        optimizer, self.lr_schedule = build_optimizer_and_schedule(
            cfg.MODEL.TRAIN.OPTIMIZATION, iters_each_epoch, epochs,
            frozen_prefixes)
        self.state = TrainState(self.model, optimizer.init(
            self.model.module.named_parameters()), self.generator,
            process_group)

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

    @property
    def revoxelizes(self):
        """cfg.TORCH_VOXEL_GENERATOR: the step's hook voxelizes the batch's
        points (`experiments.between_dataloading_and_feedforward`)."""
        return bool(self.cfg.get('TORCH_VOXEL_GENERATOR', False))

    def step_coords(self, batch):
        """The voxel coords (B, V, 3) that the step's hook will give the
        batch's points, without gradients: host books and a model's host
        targets (`coord_targets`) are built from them before the step."""
        with torch.no_grad():
            return between_dataloading_and_feedforward(
                batch, self.cfg, train=True)['coordinates']

    @property
    def coords_before_step(self):
        """Under cfg.TORCH_VOXEL_GENERATOR, whether the batch needs the
        step's voxel coords before the step (`step_coords`): for host books
        or a model's host targets.  With device books alone the step's
        forward builds its books from the hook's coords, so the points are
        voxelized once."""
        return hasattr(self.model, 'build_books') and (
            host_books.use_host_books() or self.model.coord_targets)

    def host_batch(self, coords, gt_boxes, anchor_targets=True):
        """What the host adds to a batch, in one upload: a sparse model's
        books at the train caps from `coords` (on the device; one copy to
        the host and the host build, or, under PCDET_HOST_BOOKS=0, books
        built on the device, none where the step's hook voxelizes), the
        anchor targets of `gt_boxes` (numpy) unless `anchor_targets` is
        False, and the model's own host targets."""
        arrays, spec, books = [], None, None
        if hasattr(self.model, 'build_books') and coords is not None:
            with span('pcdet.books'):
                if host_books.use_host_books():           # SECOND, Part-A²
                    coords = coords.cpu().numpy()
                    flat = self.model.build_books(coords, train=True)
                    spec = self.model.host_book_spec(coords.shape[1],
                                                     train=True)
                    arrays = host_books.wire_arrays(flat, spec)
                elif not self.revoxelizes:
                    books = self.model.device_books(coords, train=True)
        targets = []
        if anchor_targets:
            labels, reg = self.targets(gt_boxes)
            targets = [('box_cls_labels', labels), ('box_reg_targets', reg)]
        targets += self.model.host_targets(coords, gt_boxes)
        out = {} if books is None else {'books': books}
        if not arrays + targets:
            return out
        t = host_books.upload(arrays + targets, self.device)
        out.update({key: t[key] for key, _ in targets})
        if spec is not None:
            out['books'] = host_books.decode_books(t, spec, self.max_voxels)
        return out

    def make_batch(self, points, point_mask, gt_boxes, point_feature_fn=None):
        """(B, P, C) f32 points and (B, P) bool mask on the trainer's device,
        (B, M, 8) gt boxes with class ids (numpy) -> a batch for `step`.

        :param point_feature_fn: optional fn(points) -> points applied
            first, differentiably (semantic painting)
        Under cfg.TORCH_VOXEL_GENERATOR the batch carries the points and
        the mask, and the step's hook voxelizes them; a sparse model's host
        books and host targets come from the same voxelization, made here
        without gradients (`coords_before_step`)."""
        if point_feature_fn is not None:
            points = point_feature_fn(points)
        if self.revoxelizes:
            batch = {'points': points, 'point_mask': point_mask}
            coords = (self.step_coords(batch) if self.coords_before_step
                      else None)
        else:
            batch = self.voxelize(points, point_mask)
            coords = batch['coordinates']
        batch.update(self.host_batch(coords, gt_boxes))
        return batch

    def upload(self, batch):
        """A collated loader batch (numpy, `datasets.build_dataloader`'s:
        the host voxelizer's voxels, the anchor targets and, for SECOND,
        the loader's `hb_*` books) -> a batch for `step`, in one upload
        (`host_books.upload_loader_batch`).  The loader's voxels are used as
        they are, unless cfg.TORCH_VOXEL_GENERATOR: then its points go up
        instead and the step's hook voxelizes them on the device; a sparse
        model's host books and host targets are built from that
        voxelization's coords, in a second upload (`coords_before_step`;
        device books are built in the step)."""
        out = host_books.upload_loader_batch(batch, self.device, self.model,
                                             train=True)
        if self.revoxelizes and self.coords_before_step:
            out.update(self.host_batch(self.step_coords(out),
                                       batch['gt_boxes'],
                                       anchor_targets=False))
        return out

    def step(self, batch, inputs=()):
        """One optimizer step on `batch`; returns the tb dict (tensors).
        The loss's gradients by `inputs` land in `self.state.input_grads`."""
        return self.state.train_step(batch, inputs)


def build_trainer(cfg, device, seed=0, total_steps=None, loads=None,
                  iters_each_epoch=None, epochs=1, frozen_prefixes=(),
                  bn_groups=1, process_group=None, sync_bn=False):
    """A trainer of `cfg.MODEL.NAME` (PointPillar, SECOND / second_net,
    PartA2 / PartA2_net).

    The schedules span `iters_each_epoch` x `epochs` steps; given only
    `total_steps`, that is one epoch of `total_steps` iterations (both
    given, they must agree).  `loads` (None: the backbone's default,
    `sparse.DEFAULT_LOADS`) picks the sparse convs' kernels;
    `frozen_prefixes` are left out of the update; `bn_groups`,
    `process_group` and `sync_bn` as `Trainer`'s."""
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
                   frozen_prefixes, bn_groups, process_group, sync_bn)
