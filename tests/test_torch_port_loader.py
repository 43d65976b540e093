"""The port's prefetching loader against pcdet_tpu's (CPU), bit for bit:

- the batches of the KITTI tree's training set (DB sampling with road
  planes, per-object and global noise, anchor targets) over 2 epochs at B2
  equal pcdet_tpu's `DataLoader`'s, key by key, dtypes included;
- the same batches under thread and process workers and under 0 and 2
  workers;
- epochs and seeds give other batches (`tests/test_loader_determinism.py`);
- the evaluation loader keeps every sample in index order;
- `host_books.make_batch_transform`'s `hb_*` books of a SECOND loader
  batch equal pcdet_tpu's `make_batch_transform`'s, at the train and the
  eval caps.
"""
import copy

import numpy as np
import pytest

from kitti_tree import assert_equal, create_infos, kitti_cfg, make_tree
from tiny_config import tiny_pointpillar_cfg, tiny_second_cfg

from pcdet_tpu.datasets import build_dataloader as jax_build_dataloader
from pcdet_tpu.datasets.dataset import collate_batch as jax_collate
from pcdet_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from pcdet_tpu.models.anchors import AnchorHeadTargets as JaxTargets
from pcdet_tpu.models.second import SECONDNet as JaxSECONDNet
from pcdet_tpu.ops import host_books as jax_books
from pcdet_tpu_torch.datasets import build_dataloader, collate_batch
from pcdet_tpu_torch.datasets.synthetic import SyntheticDataset
from pcdet_tpu_torch.models.anchors import AnchorHeadTargets
from pcdet_tpu_torch.models.pointpillar import PointPillar
from pcdet_tpu_torch.models.second import SECONDNet
from pcdet_tpu_torch.ops import host_books

CLASSES = ['Car', 'Pedestrian', 'Cyclist']


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kitti'))
    make_tree(root)
    create_infos(root)
    return root


def _batches(loader, epochs=(0, 1)):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


def _port_loader(root, workers, mode='thread', seed=0, training=True):
    cfg = kitti_cfg(root)
    ds, loader = build_dataloader(cfg, 2, training=training,
                                  num_workers=workers, seed=seed,
                                  worker_mode=mode)
    ds.set_anchor_targets(AnchorHeadTargets(
        cfg.MODEL.RPN.RPN_HEAD.TARGET_CONFIG, ds.grid_size, CLASSES))
    return loader


def test_batches_equal_pcdet_tpu(tree):
    cfg = kitti_cfg(tree)
    jds, jloader = jax_build_dataloader(cfg, 2, training=True, num_workers=2)
    jds.set_anchor_targets(JaxTargets(cfg.MODEL.RPN.RPN_HEAD.TARGET_CONFIG,
                                      jds.grid_size, CLASSES))
    got = _batches(_port_loader(tree, 2))
    assert [len(e) for e in got] == [2, 2]
    assert_equal(got, _batches(jloader), 'batches')
    b = got[0][0]
    assert b['voxels'].shape[:2] == (2, 2000) and b['batch_size'] == 2
    assert (b['box_cls_labels'] > 0).any()


@pytest.mark.parametrize('mode,workers', [('thread', 0), ('process', 2),
                                          ('process', 0)])
def test_batches_equal_across_modes_and_workers(tree, mode, workers):
    assert_equal(_batches(_port_loader(tree, workers, mode)),
                 _batches(_port_loader(tree, 2, 'thread')), 'batches')


def test_epochs_and_seeds_differ(tree):
    e0, e1 = _batches(_port_loader(tree, 2, seed=7))
    assert not np.array_equal(e0[0]['voxels'], e1[0]['voxels'])
    other = _batches(_port_loader(tree, 2, seed=8), epochs=(0,))[0]
    assert not np.array_equal(other[0]['voxels'], e0[0]['voxels'])


def test_eval_loader_keeps_every_sample_in_order(tree):
    loader = _port_loader(tree, 2, training=False)
    loader.batch_size = 3                        # 2 val frames: one short
    batches = list(loader)
    assert len(loader) == 1 and [b['batch_size'] for b in batches] == [2]
    assert list(batches[0]['sample_idx']) == ['000004', '000005']
    assert 'box_cls_labels' not in batches[0]


@pytest.mark.parametrize('training', [True, False])
def test_batch_transform_books_equal_pcdet_tpu(training):
    cfg = tiny_second_cfg(num_class=3)
    cfg.DATA_CONFIG.SYNTHETIC = {'NUM_SAMPLES': 2, 'NUM_OBJECTS': 8}
    ds = SyntheticDataset(cfg, training=True)
    jds = JaxSynthetic(cfg, training=True)
    for d in (ds, jds):
        d.set_sample_seed(0, 0)
    batch = collate_batch([ds[0], ds[1]])
    assert_equal(batch, jax_collate([jds[0], jds[1]]), 'collated')
    model = SECONDNet(cfg, ds.grid_size, device='cpu')
    jmodel = JaxSECONDNet(cfg, jds.grid_size)
    got = host_books.make_batch_transform(model, training)(
        copy.deepcopy(batch))
    want = jax_books.make_batch_transform(jmodel, training)(
        copy.deepcopy(batch))
    keys = sorted(k for k in want if k.startswith('hb_'))
    assert len(keys) > 10
    assert sorted(k for k in got if k.startswith('hb_')) == keys
    assert_equal({k: got[k] for k in keys}, {k: want[k] for k in keys})
    pointpillar = PointPillar(tiny_pointpillar_cfg(3), ds.grid_size,
                              device='cpu')
    assert host_books.make_batch_transform(pointpillar, training) is None
