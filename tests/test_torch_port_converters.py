"""pcdet_tpu_torch's data tooling vs pcdet_tpu's (CPU): the Argoverse and
nuScenes -> KITTI-format converters, their tree writer, the split files and
the convert CLI, and the configs they feed.

- tests/test_converters.py's fabricated Argoverse and nuScenes raw trees go
  through both packages' converters: the same counts and every output file
  (velodyne, calib, label, planes, image, ImageSets) byte for byte equal;
- `python -m pcdet_tpu_torch.tools.convert_to_kitti` (its `main`) on the
  same trees writes the same files;
- the pinned split files are the same bytes, and `splits` gives
  pcdet_tpu's files and ids (the copies' code is held equal to
  pcdet_tpu's by tests/test_torch_port_imports.py);
- each of tools/cfgs/argo/*.yaml and tools/cfgs/PartA2_car.yaml builds
  through `models.build.build_network` on the CPU (random weights from a
  seed, no step), its anchors pcdet_tpu's, within 30 s.
"""
import glob
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_converters import _make_mini_argo, _make_mini_nuscenes

from pcdet_tpu.datasets import splits as jax_splits
from pcdet_tpu.datasets.converters import argoverse as jax_argo
from pcdet_tpu.datasets.converters import nuscenes as jax_nusc
from pcdet_tpu.models.anchors import AnchorHeadTargets as JaxTargets
from pcdet_tpu_torch import config
from pcdet_tpu_torch.datasets import splits
from pcdet_tpu_torch.datasets.converters import argoverse, nuscenes
from pcdet_tpu_torch.models.build import build_network
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.tools import convert_to_kitti

REPO = Path(__file__).resolve().parent.parent


def _files(root):
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def _quiet(*_):
    pass


@pytest.fixture(scope='module')
def raw_trees(tmp_path_factory):
    train_logs, val_logs = jax_argo.load_pinned_splits()
    argo = tmp_path_factory.mktemp('argo_raw')
    _make_mini_argo(argo, train_logs[:2] + val_logs[:1])
    train_scenes, val_scenes = jax_nusc.load_pinned_splits()
    nusc = tmp_path_factory.mktemp('nusc_raw')
    version = _make_mini_nuscenes(str(nusc), [train_scenes[0],
                                              val_scenes[0]])
    return {'argoverse': (str(argo), {}),
            'nuscenes': (str(nusc), {'version': version})}


@pytest.mark.parametrize('dataset', ['argoverse', 'nuscenes'])
def test_converters_write_pcdet_tpus_files(raw_trees, tmp_path, dataset):
    src, kw = raw_trees[dataset]
    jax_conv, conv = ((jax_argo, argoverse) if dataset == 'argoverse'
                      else (jax_nusc, nuscenes))
    want_counts = jax_conv.convert(src, str(tmp_path / 'jax'), logger=_quiet,
                                   **kw)
    got_counts = conv.convert(src, str(tmp_path / 'port'), logger=_quiet,
                              **kw)
    assert got_counts == want_counts and sum(want_counts.values()) >= 4
    want = _files(tmp_path / 'jax')
    got = _files(tmp_path / 'port')
    assert sorted(got) == sorted(want)
    assert any(k.startswith('training/label_2/') for k in got)
    for name, data in want.items():
        assert got[name] == data, name
    labels = [v for k, v in got.items() if k.startswith('training/label_2/')]
    assert any(b'Car' in v for v in labels)

    # the CLI twin on the same raw tree
    args = [dataset, '--src', src, '--dst', str(tmp_path / 'cli')]
    if dataset == 'nuscenes':
        args += ['--version', kw['version']]
    assert convert_to_kitti.main(args) == want_counts
    assert _files(tmp_path / 'cli') == want


def test_split_files_and_splits_equal_pcdet_tpu(tmp_path):
    ours = sorted((REPO / 'pcdet_tpu_torch' / 'datasets' / 'converters'
                   / 'splits').glob('*.txt'))
    theirs = sorted((REPO / 'pcdet_tpu' / 'datasets' / 'converters'
                     / 'splits').glob('*.txt'))
    assert [p.name for p in ours] == [p.name for p in theirs] and ours
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes(), a.name
    assert argoverse.load_pinned_splits() == jax_argo.load_pinned_splits()
    assert nuscenes.load_pinned_splits() == jax_nusc.load_pinned_splits()
    splits.write_split_files(str(tmp_path / 'a'), ['l0', 'l1'], ['l2'])
    jax_splits.write_split_files(str(tmp_path / 'b'), ['l0', 'l1'], ['l2'])
    assert _files(tmp_path / 'a') == _files(tmp_path / 'b')
    assert splits.load_split(str(tmp_path / 'a'), 'train') == ['l0', 'l1']
    frames = {'l0': 2, 'l1': 1}
    assert (splits.kitti_style_sample_ids(['l0', 'l1'], frames)
            == jax_splits.kitti_style_sample_ids(['l0', 'l1'], frames)
            == ['000000000', '000000001', '001000000'])


CONFIGS = sorted(glob.glob(str(REPO / 'tools' / 'cfgs' / 'argo' / '*.yaml'))
                 ) + [str(REPO / 'tools' / 'cfgs' / 'PartA2_car.yaml')]


@pytest.mark.parametrize('path', CONFIGS, ids=lambda p: Path(p).stem)
def test_config_builds(path):
    t0 = time.perf_counter()
    cfg = config.cfg_from_yaml_file(path)
    dc = cfg.DATA_CONFIG
    grid = grid_size(tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE),
                     tuple(dc.POINT_CLOUD_RANGE))
    model = build_network(cfg, grid, device='cpu',
                          generator=torch.Generator().manual_seed(0))
    head = cfg.MODEL.RPN.RPN_HEAD
    want = JaxTargets(head.TARGET_CONFIG, np.asarray(grid),
                      list(cfg.CLASS_NAMES))
    np.testing.assert_array_equal(model.anchors.numpy(), want.anchors)
    params = list(model.module.parameters())
    assert sum(p.numel() for p in params) > 10 ** 6
    assert all(bool(torch.isfinite(p).all()) for p in params)
    assert time.perf_counter() - t0 < 30
