"""Detection, raw scan to boxes, for PointPillar, SECOND and Part-A².

    cfg = load_config()                       # tools/cfgs/pointpillar.yaml
    det = build_detector(cfg, 'cuda', seed=0)
    points, mask = make_scans(cfg, batch=2)   # bench.py's synthetic scans
    preds = det.detect(torch.as_tensor(points, device='cuda'),
                       torch.as_tensor(mask, device='cuda'))

`build_detector` dispatches on `cfg.MODEL.NAME`.  The evaluation
(`train.eval_loop.eval_one_epoch`) runs a detector's `forward` and
`model.predict` itself.  PointPillar's `detect`
runs voxelize_torch -> PointPillarNet (VFE, scatter, RPNV2) -> predict
(masked top-k, decode of the survivors, batched rotated NMS).  SECOND's
(`load_config(SECOND_CFG)`) runs voxelize_torch on the device, one copy of
the coords to the host, the host rulebook build, one upload of the books
(under PCDET_HOST_BOOKS=0: the books built on the device instead,
`ops/host_books.build_books_device`), SECONDNetModule (MeanVFE, BackBone8x
sparse convs, RPNV2) and predict;
`build_detector(cfg, device, loads=ops.sparse.Loads(fwd, dw))` chooses the
sparse convs' load strategy (`ops.sparse.DEFAULT_LOADS` unless given).
Part-A²'s (`load_config(PARTA2_CFG)`, or `PARTA2_FC_CFG` for Part-A²-fc)
runs the same books into PartA2Net: MeanVFE, the UNetV2 sparse convs,
RPNV2, the proposal layer (NMS through kernel A), RoI-aware pooling, the
RCNN head, and the final NMS of the refined boxes.  A data loader's
voxelized batch (`datasets.build_dataloader`) goes to the device through
`upload`, with the sparse models' books from the loader; under the fork's
cfg.TORCH_VOXEL_GENERATOR (USE_PSEUDOLIDAR, INJECT_SEMANTICS) its points are
voxelized again on the device instead, at the TEST caps.
`build_detector(cfg, device, checkpoint=path)` (a `train.checkpoint`
`.pth`, or a reference one) or `state_dict=sd` puts trained weights in
place of the random ones.
"""
from pathlib import Path

import numpy as np
import torch

from .config import cfg_from_yaml_file
from .datasets.synthetic import make_scene
from .experiments import between_dataloading_and_feedforward
from .models.build import SPARSE_MODELS, build_network
from .ops import host_books
from .ops.voxelizer import grid_size, voxelize_torch
from .utils.profiler import span
from .weights import load_checkpoint, model_state

CFG_DIR = Path(__file__).resolve().parent.parent / 'tools' / 'cfgs'
DEFAULT_CFG = CFG_DIR / 'pointpillar.yaml'
SECOND_CFG = CFG_DIR / 'second.yaml'
PARTA2_CFG = CFG_DIR / 'PartA2.yaml'
PARTA2_FC_CFG = CFG_DIR / 'PartA2_fc.yaml'


def load_config(path=DEFAULT_CFG):
    return cfg_from_yaml_file(str(path))


def make_scans(cfg, batch, ring_keep=1.0):
    """Synthetic KITTI-scale scans exactly as `bench.py` makes them: scene i
    from RandomState(i), 24 objects on beam-structured ground, padded to
    DATA_CONFIG.MAX_POINTS (65536, bench.py's MAX_POINTS).  `ring_keep`
    0.35 is `scripts/bench_models.py`'s realistic SECOND density.

    :return: points (B, P, 4) f32, point_mask (B, P) bool
    """
    max_points = int(cfg.DATA_CONFIG.MAX_POINTS)
    points = np.zeros((batch, max_points, 4), np.float32)
    mask = np.zeros((batch, max_points), bool)
    for i in range(batch):
        pts, _, _ = make_scene(np.random.RandomState(i), list(cfg.CLASS_NAMES),
                               num_objects=24, ground_mode='rings',
                               pts_per_obj=400, x_range=(3, 68),
                               y_range=(-38, 38), ring_keep=ring_keep)
        n = min(len(pts), max_points)
        points[i, :n] = pts[:n]
        mask[i, :n] = True
    return points, mask


class Detector:
    """PointPillar, SECOND or Part-A² (`models.build.build_network` by
    `cfg.MODEL.NAME`) with random weights from `seed` (a CPU
    torch.Generator, so every device gets the same weights), or the
    weights of `state_dict` (the module's reference-keyed state_dict)."""

    def __init__(self, cfg, device, seed=0, loads=None, state_dict=None):
        data_cfg = cfg.DATA_CONFIG
        self.voxel_size = tuple(data_cfg.VOXEL_GENERATOR.VOXEL_SIZE)
        self.pc_range = tuple(data_cfg.POINT_CLOUD_RANGE)
        self.max_points_per_voxel = int(
            data_cfg.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL)
        self.max_voxels = int(data_cfg.TEST.MAX_NUMBER_OF_VOXELS)
        gen = torch.Generator().manual_seed(seed)
        self.model = build_network(
            cfg, grid_size(self.voxel_size, self.pc_range), device=device,
            generator=gen, loads=loads)
        if state_dict is not None:
            self.model.module.load_state_dict(state_dict)
        self.device = self.model.device

    def voxelize(self, points, point_mask):
        return voxelize_torch(points, point_mask, self.voxel_size,
                              self.pc_range, self.max_points_per_voxel,
                              self.max_voxels)

    def forward(self, points, point_mask):
        """A batch's voxelizer outputs and the model's raw outputs, (vox,
        ret); the predictions are `self.model.predict(ret)`."""
        vox = self.voxelize(points, point_mask)
        return vox, self.model.forward(vox)

    @property
    def revoxelizes(self):
        """cfg.TORCH_VOXEL_GENERATOR: a loader batch's points are voxelized
        again on the device, at the TEST caps."""
        return bool(self.model.cfg.get('TORCH_VOXEL_GENERATOR', False))

    def upload(self, batch):
        """A collated eval batch of the data loader (numpy: the host
        voxelizer's voxels, gt_boxes, a sparse model's `hb_*` books) -> the
        model's batch on the device, in one upload (`host_books.
        upload_loader_batch`).  Under cfg.TORCH_VOXEL_GENERATOR the points
        go up instead and the fork's hook voxelizes them at the TEST caps
        (`experiments.between_dataloading_and_feedforward`, as
        `pcdet_tpu`'s eval forward does)."""
        out = host_books.upload_loader_batch(batch, self.device, self.model,
                                             train=False)
        if self.revoxelizes:
            out = between_dataloading_and_feedforward(out, self.model.cfg,
                                                      train=False)
        return out

    @torch.inference_mode()
    def detect(self, points, point_mask):
        """(B, P, 4) f32 points, (B, P) bool mask on the detector's device
        -> dict boxes (B, post, 7), scores, labels, valid, num (B,)."""
        ret = self.forward(points, point_mask)[1]
        with span('pcdet.predict'):
            return self.model.predict(ret)


class SparseDetector(Detector):
    """SECOND or Part-A²: the sparse backbone runs over rulebooks built on
    the host (or, under PCDET_HOST_BOOKS=0, on the device) from the
    voxelizer's coords, its kw=3 convs by `loads`
    (`ops.sparse.Loads`)."""

    @property
    def loads(self):
        """The backbone's `ops.sparse.Loads` (its default when given None)."""
        return self.model.module.rpn_net.loads

    def books(self, vox):
        """One device -> host copy of the coords (the mask is coords >= 0),
        the host build, one upload: decoded books on the device; under
        PCDET_HOST_BOOKS=0 the same books built on the device
        (`model.device_books`), with no copy."""
        with span('pcdet.books'):
            if not host_books.use_host_books():
                return self.model.device_books(vox['coordinates'])
            coords = vox['coordinates'].cpu().numpy()
            return self.model.upload_books(self.model.build_books(coords),
                                           coords.shape[1])

    def upload(self, batch):
        """`Detector.upload`; under cfg.TORCH_VOXEL_GENERATOR the books are
        built from the device voxelization's coords."""
        out = super().upload(batch)
        if self.revoxelizes:
            out['books'] = self.books(out)
        return out

    def forward(self, points, point_mask):
        """`Detector.forward` with the books built between the voxelizer and
        the model."""
        vox = self.voxelize(points, point_mask)
        vox['books'] = self.books(vox)
        return vox, self.model.forward(vox)

    @torch.inference_mode()
    def detect_batch(self, batch):
        """A voxelized batch on the device that may carry the loader's
        `hb_*` books (numpy) -> the predictions of `detect`."""
        ret = self.model.forward(batch)
        with span('pcdet.predict'):
            return self.model.predict(ret)


def build_detector(cfg, device, seed=0, loads=None, checkpoint=None,
                   state_dict=None):
    """PointPillar, SECOND or Part-A² by `cfg.MODEL.NAME`.

    :param loads: the sparse convs' `ops.sparse.Loads` (SECOND, Part-A²;
        None: the backbone's default, `ops.sparse.DEFAULT_LOADS`);
        PointPillar has no sparse convs and takes none
    :param checkpoint: a `.pth` whose `model_state` (or which, as a bare
        state_dict) gives the weights, loaded onto `device`
    :param state_dict: the weights as a state_dict
    """
    if checkpoint is not None:
        if state_dict is not None:
            raise ValueError('give a checkpoint or a state_dict, not both')
        state_dict = model_state(load_checkpoint(checkpoint, device))
    cls = SparseDetector if cfg.MODEL.NAME in SPARSE_MODELS else Detector
    return cls(cfg, device, seed, loads, state_dict)
