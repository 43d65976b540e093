"""Detection, raw scan to boxes, for PointPillar and SECOND.

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
the coords to the host, the host rulebook build, one upload of the books,
SECONDNetModule (MeanVFE, BackBone8x sparse convs, RPNV2) and predict;
`build_detector(cfg, device, loads=ops.sparse.Loads(fwd, dw))` chooses the
sparse convs' load strategy (`ops.sparse.DEFAULT_LOADS` unless given).
"""
from pathlib import Path

import numpy as np
import torch

from .config import cfg_from_yaml_file
from .datasets.synthetic import make_scene
from .models.pointpillar import PointPillar
from .models.second import SECONDNet
from .ops.voxelizer import grid_size, voxelize_torch

CFG_DIR = Path(__file__).resolve().parent.parent / 'tools' / 'cfgs'
DEFAULT_CFG = CFG_DIR / 'pointpillar.yaml'
SECOND_CFG = CFG_DIR / 'second.yaml'


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
    """PointPillar with random weights from `seed` (a CPU torch.Generator,
    so every device gets the same weights)."""
    model_class = PointPillar

    def __init__(self, cfg, device, seed=0, **model_args):
        data_cfg = cfg.DATA_CONFIG
        self.voxel_size = tuple(data_cfg.VOXEL_GENERATOR.VOXEL_SIZE)
        self.pc_range = tuple(data_cfg.POINT_CLOUD_RANGE)
        self.max_points_per_voxel = int(
            data_cfg.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL)
        self.max_voxels = int(data_cfg.TEST.MAX_NUMBER_OF_VOXELS)
        gen = torch.Generator().manual_seed(seed)
        self.model = self.model_class(
            cfg, grid_size(self.voxel_size, self.pc_range), device=device,
            generator=gen, **model_args)
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

    @torch.inference_mode()
    def detect(self, points, point_mask):
        """(B, P, 4) f32 points, (B, P) bool mask on the detector's device
        -> dict boxes (B, post, 7), scores, labels, valid, num (B,)."""
        return self.model.predict(self.forward(points, point_mask)[1])


class SecondDetector(Detector):
    """SECOND with random weights from `seed`; the sparse backbone runs over
    rulebooks built on the host from the voxelizer's coords, its kw=3 convs
    by `loads` (`ops.sparse.Loads`)."""
    model_class = SECONDNet

    def __init__(self, cfg, device, seed=0, loads=None):
        super().__init__(cfg, device, seed, loads=loads)

    @property
    def loads(self):
        """The backbone's `ops.sparse.Loads` (its default when given None)."""
        return self.model.module.rpn_net.loads

    def books(self, vox):
        """One device -> host copy of the coords (the mask is coords >= 0),
        the host build, one upload: decoded books on the device."""
        coords = vox['coordinates'].cpu().numpy()
        return self.model.upload_books(self.model.build_books(coords),
                                       coords.shape[1])

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
        return self.model.predict(self.model.forward(batch))


def build_detector(cfg, device, seed=0, loads=None):
    """PointPillar or SECOND by `cfg.MODEL.NAME`.

    :param loads: SECOND's `ops.sparse.Loads` (None: the backbone's
        default, `ops.sparse.DEFAULT_LOADS`);
        PointPillar has no sparse convs and takes none
    """
    name = cfg.MODEL.NAME          # the names pcdet_tpu.models.build takes
    if name in ('SECOND', 'second_net'):
        return SecondDetector(cfg, device, seed, loads)
    if loads is not None:
        raise ValueError('loads apply to SECOND\'s sparse convs, not %r'
                         % name)
    if name == 'PointPillar':
        return Detector(cfg, device, seed)
    raise ValueError('no port of model %r' % cfg.MODEL.NAME)
