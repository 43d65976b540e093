"""The port's data pipeline against pcdet_tpu's, bit for bit (CPU).

Every comparison is `np.array_equal` with equal dtypes, on the same inputs
and the same seeded RandomState streams:

- the host `VoxelGenerator` (native, csrc/voxelizer_native.cpp) below the
  voxel cap and past it;
- the scene past the cap, pinned: the loader's voxels (first-appearance
  order, capped, sorted by id) equal pcdet_tpu's loader voxels, and
  `voxelize_torch` keeps other voxels there (the lowest ids), the same
  count and the same overflow count;
- `noise_per_object_v3_` (native first-success search), `random_flip`,
  `global_rotation`, `global_scaling`;
- `DataBaseSampler.sample_all` with a per-sample RandomState and with the
  global stream's shuffled cycle, with road planes;
- `prepare_data` through `KittiDataset.__getitem__` in training (DB
  sampling, per-object and global noise, shuffle, anchor targets) and in
  evaluation, key by key, and the Part-A² per-voxel targets.
"""
import copy
import os
import pickle

import numpy as np
import pytest
import torch

from kitti_tree import assert_equal, create_infos, kitti_cfg, make_tree
from tiny_config import tiny_pointpillar_cfg

from pcdet_tpu.datasets.augmentation import augmentation_utils as jax_aug
from pcdet_tpu.datasets.augmentation import dbsampler as jax_db
from pcdet_tpu.datasets.dataset import DatasetTemplate as JaxTemplate
from pcdet_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKitti
from pcdet_tpu.datasets.synthetic import make_scene
from pcdet_tpu.models.anchors import AnchorHeadTargets as JaxTargets
from pcdet_tpu.ops.voxelizer import VoxelGenerator as JaxVoxelGenerator
from pcdet_tpu.utils.calibration import Calibration as JaxCalibration
from pcdet_tpu_torch.datasets.augmentation import augmentation_utils as aug
from pcdet_tpu_torch.datasets.augmentation import dbsampler
from pcdet_tpu_torch.datasets.dataset import DatasetTemplate
from pcdet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
from pcdet_tpu_torch.models.anchors import AnchorHeadTargets
from pcdet_tpu_torch.ops.voxelizer import VoxelGenerator, voxelize_torch
from pcdet_tpu_torch.utils.calibration import Calibration

CLASSES = ['Car', 'Pedestrian', 'Cyclist']


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kitti'))
    make_tree(root)
    create_infos(root)
    return root


def _scene(seed, num_objects=8):
    pts, boxes, names = make_scene(np.random.RandomState(seed), CLASSES,
                                   num_objects=num_objects, x_range=(3, 30),
                                   y_range=(-14, 14))
    return pts, boxes, names


@pytest.mark.parametrize('cap', [100000, 600, 200])
@pytest.mark.parametrize('pad', [True, False])
def test_voxel_generator_equals_pcdet_tpu(cap, pad):
    pts, _, _ = _scene(1)
    args = ([0.5, 0.5, 4], [0, -16, -3, 32, 16, 1], 16, cap)
    got = VoxelGenerator(*args).generate(pts, pad_to_max=pad)
    want = JaxVoxelGenerator(*args).generate(pts, pad_to_max=pad)
    assert_equal(got, want)
    assert (got['num_voxels'] == cap) == (cap < 100000)


def _template_pair(cfg, training):
    got, want = DatasetTemplate(cfg, training=training), JaxTemplate(
        cfg, training=training)
    return got, want


def test_overflowing_scene_is_pinned_to_the_loader_voxels():
    """Past MAX_NUMBER_OF_VOXELS the loader keeps the voxels that appear
    first, as pcdet_tpu's loader does; `voxelize_torch` (the port's device
    voxelizer) keeps the lowest ids.  Both keep `cap` voxels and count the
    same overflow."""
    cfg = tiny_pointpillar_cfg(num_class=3)
    cfg.DATA_CONFIG.TEST.MAX_NUMBER_OF_VOXELS = 600
    pts, boxes, names = _scene(2)
    raw = {'sample_idx': 0, 'points': pts, 'gt_boxes_lidar': boxes,
           'gt_names': names}
    got_ds, want_ds = _template_pair(cfg, training=False)
    got = got_ds.prepare_data(copy.deepcopy(raw), rng=np.random.RandomState(0))
    want = want_ds.prepare_data(copy.deepcopy(raw),
                                rng=np.random.RandomState(0))
    assert_equal(got, want)
    cap = 600
    assert got['voxel_mask'].sum() == cap and got['voxel_overflow'] > 0

    dc = cfg.DATA_CONFIG
    p = torch.as_tensor(pts)[None]
    dev = voxelize_torch(p, torch.ones(p.shape[:2], dtype=torch.bool),
                         tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE),
                         tuple(dc.POINT_CLOUD_RANGE),
                         dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL, cap)
    grid = got_ds.voxel_generator.grid_size

    def ids(c):
        c = c[c[:, 0] >= 0].astype(np.int64)
        return (c[:, 0] * grid[1] + c[:, 1]) * grid[0] + c[:, 2]

    loader_ids = ids(got['coordinates'])
    device_ids = ids(dev['coordinates'][0].numpy())
    assert len(loader_ids) == len(device_ids) == cap
    assert np.all(np.diff(loader_ids) > 0) and np.all(np.diff(device_ids) > 0)
    assert int(dev['voxel_overflow'][0]) == int(got['voxel_overflow'])
    # the device voxelizer keeps the lowest ids of every occupied voxel
    all_ids = ids(VoxelGenerator(dc.VOXEL_GENERATOR.VOXEL_SIZE,
                                 dc.POINT_CLOUD_RANGE, 16, 10 ** 6).generate(
        pts[(pts[:, 0] >= 0) & (pts[:, 0] <= 32) & (np.abs(pts[:, 1]) <= 16)]
    )['coordinates'])
    np.testing.assert_array_equal(device_ids, np.sort(all_ids)[:cap])
    differ = np.setdiff1d(loader_ids, device_ids)
    assert len(differ) > 0, 'the overflowing scene keeps the same voxels'


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_noise_per_object_equals_pcdet_tpu(seed):
    pts, boxes, _ = _scene(seed + 10, num_objects=12)
    valid = np.random.RandomState(seed).rand(len(boxes)) < 0.8
    outs = []
    for fn in (aug.noise_per_object_v3_, jax_aug.noise_per_object_v3_):
        outs.append(fn(boxes.copy(), pts.copy(), valid.copy(),
                       rotation_perturb=[-0.785, 0.785],
                       center_noise_std=[1.0, 1.0, 0.1], num_try=100,
                       rng=np.random.RandomState(seed)))
    assert_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0][0], boxes), 'no box moved'


@pytest.mark.parametrize('seed', [0, 3])
def test_global_noise_equals_pcdet_tpu(seed):
    pts, boxes, _ = _scene(seed + 20)
    outs = []
    for mod in (aug, jax_aug):
        rng = np.random.RandomState(seed)
        b, p = mod.random_flip(boxes.copy(), pts.copy(), rng=rng)
        b, p = mod.global_rotation(b, p, rotation=[-0.785, 0.785], rng=rng)
        b, p = mod.global_scaling(b, p, 0.95, 1.05, rng=rng)
        outs.append((b, p))
    assert_equal(outs[0], outs[1])


def _sampler_cfg(cfg):
    return cfg.DATA_CONFIG.AUGMENTATION.DB_SAMPLER


def _db_infos(root):
    with open(os.path.join(root, 'kitti_dbinfos_train.pkl'), 'rb') as f:
        return pickle.load(f)


@pytest.mark.parametrize('per_sample', [True, False])
def test_db_sampler_sample_all_equals_pcdet_tpu(tree, per_sample):
    cfg = kitti_cfg(tree)
    calib_file = os.path.join(tree, 'training', 'calib', '000000.txt')
    plane = JaxKitti(cfg, training=True).get_road_plane('000000')
    gt_boxes = np.array([[15.0, -2.0, -1.0, 1.7, 4.0, 1.5, 0.3]], np.float32)
    gt_names = np.array(['Car'])
    outs = []
    for mod, calib in ((dbsampler, Calibration(calib_file)),
                       (jax_db, JaxCalibration(calib_file))):
        np.random.seed(5)          # the cycle's shuffles draw from it
        sampler = mod.DataBaseSampler(_db_infos(tree), _sampler_cfg(cfg),
                                      CLASSES)
        outs.append([sampler.sample_all(
            tree, gt_boxes, gt_names, road_planes=plane, calib=calib,
            rng=np.random.RandomState(k) if per_sample else None)
            for k in range(3)])
    assert_equal(outs[0], outs[1])
    assert all(o is not None and len(o['gt_boxes']) > 0 for o in outs[0])


def _dataset_pair(cfg, training, seed=3):
    got, want = KittiDataset(cfg, training=training), JaxKitti(
        cfg, training=training)
    grid = got.grid_size
    got.set_anchor_targets(AnchorHeadTargets(
        cfg.MODEL.RPN.RPN_HEAD.TARGET_CONFIG, grid, cfg.CLASS_NAMES))
    want.set_anchor_targets(JaxTargets(
        cfg.MODEL.RPN.RPN_HEAD.TARGET_CONFIG, grid, cfg.CLASS_NAMES))
    for ds in (got, want):
        ds.set_sample_seed(seed, 1)
    return got, want


@pytest.mark.parametrize('parta2', [False, True])
def test_prepare_data_train_equals_pcdet_tpu(tree, parta2):
    cfg = kitti_cfg(tree, parta2=parta2)
    got, want = _dataset_pair(cfg, training=True)
    assert len(got) == len(want) == 4
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert_equal(g, w, 'train example %d' % i)
        assert (g['box_cls_labels'] > 0).any()
        assert ('part_labels' in g) == parta2
    if parta2:
        assert (g['seg_labels'] > 0).any() and (g['part_labels'] > 0).any()


def test_prepare_data_eval_equals_pcdet_tpu(tree):
    cfg = kitti_cfg(tree)
    got, want = _dataset_pair(cfg, training=False)
    assert len(got) == 2
    for i in range(len(got)):
        g = got[i]
        assert_equal(g, want[i], 'eval example %d' % i)
        assert 'box_cls_labels' not in g and g['gt_boxes'][:, 7].max() == 1
