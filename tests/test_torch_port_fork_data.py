"""The data half of the port's BEVSEG fork layer, on the CPU:

- `read_png` (zlib and struct, for the card's machine, which has no PIL)
  equals `np.array(PIL.Image.open(f))` on hand-made files of every colour
  type it decodes (grey at 1 and 8 bits, RGB, palette indices, grey +
  alpha, RGBA), each with all five scanline filters, and on PIL's own
  files; it raises ValueError on interlaced and 16-bit files;
- `KittiDataset.get_bev`, `get_colored_lidar` and `__getitem__` with
  TAG_PTS_WITH_RGB and MODE bev equal pcdet_tpu's bit for bit on a
  fabricated tree with BEV maps;
- a loader batch carries `points`, `point_mask` and `bev` through
  `host_books.upload_loader_batch` (the loader's voxels stay on the host
  under USE_PSEUDOLIDAR), and the detector's upload voxelizes them at the
  TEST caps as pcdet_tpu's eval forward does;
- the train CLI -> test CLI under `--set USE_PSEUDOLIDAR True MODE
  3dobjdet+bev`: `bev_loss` in every logged step, the tensorboard event
  file written, the test CLI's logged AP string equal to the evaluator on
  its result.pkl;
- the train CLI freezes what `experiments.training_before_epoch` names
  (`seg_model` under INJECT_SEMANTICS), and `--multi_host` outside
  torchrun's environment raises, naming the launch.
"""
import os
import pickle
import re
import struct
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from kitti_tree import assert_equal, make_tree

from pcdet_tpu import experiments as jax_exp
from pcdet_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKitti
from pcdet_tpu.models.anchors import AnchorHeadTargets as JaxTargets
from pcdet_tpu_torch import detect
from pcdet_tpu_torch.datasets import build_dataloader
from pcdet_tpu_torch.datasets.kitti import kitti_eval_cli
from pcdet_tpu_torch.datasets.kitti.kitti_dataset import (KittiDataset,
                                                          read_png)
from pcdet_tpu_torch.models.anchors import AnchorHeadTargets
from pcdet_tpu_torch.ops import host_books
from pcdet_tpu_torch.tools import create_data, test, train
from pcdet_tpu_torch.train import train_loop

from test_kitti_dataset import _kitti_cfg
from test_torch_port_cli import _cfg, _logged_result, _plain

torch.set_num_threads(1)

CLASSES = ['Car', 'Pedestrian', 'Cyclist']
FORK_SETS = ['USE_PSEUDOLIDAR', 'True', 'MODE', '3dobjdet+bev']


# ---------------------------------------------------------------------------
# the PNG decoder
# ---------------------------------------------------------------------------

def _chunk(tag, data):
    return (struct.pack('>I', len(data)) + tag + data
            + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))


def _filtered(rows, bpp):
    """Each row of (H, stride) uint8 under filter (row index % 5)."""
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - up_left))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, up_left))
        out.append(bytes([kind]) + ((row - pred) % 256).astype(
            np.uint8).tobytes())
        prior = row
    return b''.join(out)


def _png(path, rows, width, depth, colour, bpp, interlace=0, extra=b''):
    ihdr = struct.pack('>IIBBBBB', width, rows.shape[0], depth, colour, 0,
                       0, interlace)
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' + _chunk(b'IHDR', ihdr) + extra
                + _chunk(b'IDAT', zlib.compress(_filtered(rows, bpp)))
                + _chunk(b'IEND', b''))


@pytest.mark.parametrize('colour,depth,channels', [
    (0, 1, 1), (0, 8, 1), (2, 8, 3), (3, 8, 1), (4, 8, 2), (6, 8, 4)])
def test_read_png_equals_pil_for_every_filter(tmp_path, colour, depth,
                                              channels):
    rng = np.random.RandomState(colour * 10 + depth)
    width, height = 23, 11                  # 11 rows: every filter twice
    stride = (width * channels * depth + 7) // 8
    rows = rng.randint(0, 256, (height, stride)).astype(np.uint8)
    rows[:, :stride // 2] = np.add.outer(np.arange(height),
                                         np.arange(stride // 2)) % 256
    extra = b''
    if colour == 3:
        rows %= 16
        extra = _chunk(b'PLTE', rng.randint(0, 256, 48).astype(
            np.uint8).tobytes())
    if depth == 1:                  # the bits past the width are padding
        rows[:, -1] &= 0xff << (8 * stride - width) & 0xff
    path = str(tmp_path / 'img.png')
    _png(path, rows, width, depth, colour, max(1, channels * depth // 8),
         extra=extra)
    want = np.array(Image.open(path))
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('mode', ['1', 'L', 'P', 'LA', 'RGB', 'RGBA'])
def test_read_png_equals_pil_on_its_own_files(tmp_path, mode):
    rng = np.random.RandomState(len(mode))
    ramp = np.add.outer(np.arange(57), np.arange(64)).astype(np.uint8)
    if mode == '1':
        im = Image.fromarray(rng.rand(57, 64) > 0.5).convert('1')
    elif mode == 'P':
        im = Image.fromarray(ramp % 7, 'L').convert('P')
    elif mode in ('L', 'LA', 'RGB', 'RGBA'):
        n = len(mode)
        a = np.stack([ramp + k * 40 for k in range(n)], -1)
        a[::3] = rng.randint(0, 256, a[::3].shape)
        im = Image.fromarray(a[..., 0] if n == 1 else a, mode)
    path = str(tmp_path / 'pil.png')
    im.save(path)
    want = np.array(Image.open(path))
    got = read_png(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('depth,interlace,what', [
    (8, 1, 'interlaced'), (16, 0, 'colour type 0 at 16 bits')])
def test_read_png_refuses_what_it_does_not_decode(tmp_path, depth, interlace,
                                                  what):
    path = str(tmp_path / 'bad.png')
    rows = np.zeros((4, 4 * depth // 8), np.uint8)
    _png(path, rows, 4, depth, 0, depth // 8, interlace=interlace)
    with pytest.raises(ValueError, match=what):
        read_png(path)


# ---------------------------------------------------------------------------
# the camera paths of the KITTI dataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def bev_tree(tmp_path_factory):
    """kitti_tree's frames, BEV maps of 400 x 400 written by PIL, infos."""
    root = str(tmp_path_factory.mktemp('kitti_bev'))
    ids = make_tree(root)
    rng = np.random.RandomState(7)
    for cls in ('DRIVABLE', 'VEHICLE'):
        d = os.path.join(root, 'training', 'bev_%s' % cls)
        os.makedirs(d)
        for sid in ids:
            m = (rng.rand(400, 400) > 0.6).astype(np.uint8) * 255
            Image.fromarray(m, mode='L').save(os.path.join(d, sid + '.png'))
    from pcdet_tpu.datasets.kitti.kitti_dataset import create_kitti_infos
    create_kitti_infos(_kitti_cfg(root), data_path=root, save_path=root,
                       workers=2)
    return root, ids


def _fork_kitti_cfg(root):
    cfg = _kitti_cfg(root)
    cfg.TAG_PTS_WITH_RGB = True
    cfg.DATA_CONFIG.NUM_POINT_FEATURES = {'total': 6, 'use': 6}
    cfg.MODE = '3dobjdet_bev'
    cfg.DATA_CONFIG.AUGMENTATION.DB_SAMPLER.ENABLED = False
    return cfg


def test_camera_paths_equal_pcdet_tpu(bev_tree):
    root, ids = bev_tree
    cfg = _fork_kitti_cfg(root)
    got_ds, want_ds = KittiDataset(cfg, training=True), JaxKitti(
        cfg, training=True)
    for sid in ids[:2]:
        bev = got_ds.get_bev(sid)
        assert bev.shape == (2, 200, 200) and bev.max() > 0
        assert_equal(bev, want_ds.get_bev(sid))
        pts = got_ds.get_colored_lidar(sid)
        assert pts.shape[1] == 6 and (pts[:, 3:] == 0).all()
        assert_equal(pts, want_ds.get_colored_lidar(sid))
    for ds in (got_ds, want_ds):        # the augmentations' draws
        ds.set_sample_seed(3, 1)
    got_ds.set_anchor_targets(AnchorHeadTargets(
        cfg.MODEL.RPN.RPN_HEAD.TARGET_CONFIG, got_ds.grid_size, CLASSES))
    want_ds.set_anchor_targets(JaxTargets(
        cfg.MODEL.RPN.RPN_HEAD.TARGET_CONFIG, want_ds.grid_size, CLASSES))
    for i in range(2):
        ex = got_ds[i]
        assert ex['voxels'].shape[-1] == 6 and ex['bev'].shape == (200, 200,
                                                                     2)
        assert_equal(ex, want_ds[i])


def _loader_batch(root, training):
    cfg = _kitti_cfg(root)
    cfg.DATA_CONFIG.AUGMENTATION.DB_SAMPLER.ENABLED = False
    cfg.USE_PSEUDOLIDAR = True
    cfg.MODE = '3dobjdet+bev'
    from pcdet_tpu_torch.config import cfg_preprocess
    cfg_preprocess(cfg)
    ds, loader = build_dataloader(cfg, 2, training=training, num_workers=0)
    det = detect.build_detector(cfg, 'cpu')
    ds.set_anchor_targets(det.model.anchor_targets)
    loader.set_epoch(0)
    return cfg, det, next(iter(loader))


def test_loader_batch_carries_points_and_bev(bev_tree):
    cfg, det, batch = _loader_batch(bev_tree[0], training=True)
    out = host_books.upload_loader_batch(batch, det.device, det.model,
                                         train=True)
    for key in ('points', 'point_mask', 'bev', 'box_cls_labels', 'gt_boxes'):
        np.testing.assert_array_equal(out[key].numpy(), batch[key],
                                      err_msg=key)
    assert out['point_mask'].dtype == torch.bool
    assert out['bev'].shape == (2, 200, 200, 2) and out['bev'].sum() > 0
    for key in ('voxels', 'num_points_per_voxel', 'coordinates'):
        assert key not in out, key
    loss, tb = det.model.loss_with_bev(det.model.forward(
        det.upload(batch)), out)
    assert np.isfinite(float(loss.detach())) and 'bev_loss' in tb


def test_detector_upload_voxelizes_at_the_test_caps(bev_tree):
    cfg, det, batch = _loader_batch(bev_tree[0], training=False)
    got = det.upload(batch)
    want = jax_exp.between_dataloading_and_feedforward(
        {'points': jnp.asarray(batch['points']),
         'point_mask': jnp.asarray(batch['point_mask'])}, cfg, train=False)
    assert got['voxels'].shape[1] == cfg.DATA_CONFIG.TEST.MAX_NUMBER_OF_VOXELS
    for key in ('voxels', 'coordinates', 'voxel_mask'):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(got['num_points_per_voxel'].numpy(),
                                  np.asarray(want['num_points']))


# ---------------------------------------------------------------------------
# the CLI pair with the fork's flags
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def cli(tmp_path_factory, bev_tree):
    root = bev_tree[0]
    base = tmp_path_factory.mktemp('fork_cli')
    cfg = _cfg(root, base / 'out')
    plain = _plain(cfg)
    plain.pop('TAG')
    cfg_file = base / 'tiny_fork.yaml'
    cfg_file.write_text(yaml.safe_dump(plain))
    create_data.main(['kitti', '--cfg_file', str(cfg_file), '--workers',
                      '2'])
    out = train.main(['--cfg_file', str(cfg_file), '--device', 'cpu',
                      '--batch_size', '2', '--epochs', '1', '--workers', '2',
                      '--ckpt_save_interval', '1', '--log_interval', '1',
                      '--set'] + FORK_SETS)
    return {'root': root, 'cfg': cfg, 'cfg_file': str(cfg_file),
            'train': out}


def test_fork_cli_round_trip(cli):
    out = cli['train']
    assert out['trainer'].revoxelizes
    assert out['trainer'].model.with_bev_seg
    log = Path(out['log_file']).read_text()
    losses = [float(x) for x in re.findall(r'iter \d+ loss ([\d.]+)', log)]
    bev = [float(x) for x in re.findall(r'bev_loss ([\d.]+)', log)]
    assert len(losses) == len(bev) == 2 and all(np.isfinite(losses + bev))
    assert len(re.findall(r'overflow/voxelizer \d+', log)) == 2
    events = list((out['output_dir'] / 'tensorboard').glob('events.*'))
    assert len(events) == 1 and events[0].stat().st_size > 0

    ckpt = str(out['ckpt_dir'] / 'checkpoint_epoch_1.pth')
    result = test.main(['--cfg_file', cli['cfg_file'], '--device', 'cpu',
                        '--batch_size', '2', '--workers', '0', '--ckpt',
                        ckpt, '--set'] + FORK_SETS)
    det = result['detector']
    assert det.revoxelizes and det.model.with_bev_seg
    eval_dir, res = result['results'][1]
    assert res['recall/gt'] == 2
    with open(eval_dir / 'result.pkl', 'rb') as f:
        det_annos = pickle.load(f)
    with open(cli['cfg'].DATA_CONFIG.TEST.INFO_PATH[0], 'rb') as f:
        gt_infos = pickle.load(f)
    again, _ = kitti_eval_cli.evaluation(det_annos, gt_infos, CLASSES)
    assert _logged_result(result['log_file']) == again.strip()


def test_train_cli_freezes_through_training_before_epoch(cli, monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def spy(cfg, device, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(train, 'build_trainer', spy)
    with pytest.raises(Stop):
        train.main(['--cfg_file', cli['cfg_file'], '--device', 'cpu',
                    '--batch_size', '2', '--workers', '0', '--extra_tag',
                    'frozen', '--set', 'INJECT_SEMANTICS', 'True'])
    assert seen['frozen_prefixes'] == ('seg_model',)
    # --multi_host joins torchrun's process group; without its environment
    # it says how to launch
    for key in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT'):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match='torch.distributed.run'):
        train.main(['--cfg_file', cli['cfg_file'], '--device', 'cpu',
                    '--multi_host'])


def test_wandb_mirror_is_optional():
    """No wandb on either machine: the mirror does nothing and raises
    nothing."""
    assert train_loop._wandb_log({'loss': 1.0}, 1) is None
