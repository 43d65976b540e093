"""pcdet_tpu_torch stands alone: it imports nothing of pcdet_tpu, and its
own copies of pcdet_tpu's framework-free helpers give the same results.

- a subprocess imports `pcdet_tpu_torch.detect`, `pcdet_tpu_torch.train.
  trainer`, the training loop's modules (`models.build`, `train.
  optimization`, `train.checkpoint`, `train.train_loop`), the evaluation's
  modules (`train.eval_loop`, the KITTI evaluator and its native bindings),
  the data pipeline's (the KITTI dataset and its helpers, the
  augmentations, the DB sampler, `datasets.dataset`, the loader, the host
  voxelizer and native bindings), the CLIs (`tools.create_data`, `train`,
  `test`) and `chip_smoke` and finds no `pcdet_tpu` module loaded;
- no source of the package, nor `chip_smoke.py`, has an import of
  `pcdet_tpu` (other than of `pcdet_tpu_torch`), nor of flax, orbax,
  tensorboardX or wandb, which the machine with the card lacks;
- the copies against pcdet_tpu, exactly: the host books (native and numpy
  builders) at the tiny config and at `tools/cfgs/second.yaml`'s eval and
  train caps at B2, the anchors and `AnchorHeadTargets.assign`, `make_scene`
  in both ground modes, and the loaded `second.yaml` / `pointpillar.yaml`;
  the KITTI evaluator's four native functions (`csrc/kitti_eval_native.cpp`)
  on random inputs; the data pipeline's native sources (`csrc/
  voxelizer_native.cpp`, `csrc/augmentation_native.cpp`) byte for byte,
  and their functions on random inputs; `SyntheticDataset`'s eval examples (points, point mask,
  padded GT with classes), GT annotations and annotations of predictions at
  the tiny config and at `second.yaml`.
"""
import copy
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tiny_config import tiny_second_cfg

from pcdet_tpu import config as jax_config
from pcdet_tpu import native as jax_native
from pcdet_tpu.datasets import synthetic as jax_synthetic
from pcdet_tpu.models.anchors import AnchorHeadTargets as JaxTargets
from pcdet_tpu.ops import host_books as jax_books
from pcdet_tpu_torch import config, detect
from pcdet_tpu_torch.datasets import synthetic
from pcdet_tpu_torch.datasets.kitti.kitti_eval import native
from pcdet_tpu_torch.models.anchors import AnchorHeadTargets
from pcdet_tpu_torch.ops import host_books, host_native
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.train.trainer import make_train_scans

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CFGS = REPO / 'tools' / 'cfgs'


def test_port_loads_no_pcdet_tpu_module():
    code = ('import sys, chip_smoke, pcdet_tpu_torch.detect, '
            'pcdet_tpu_torch.train.trainer, pcdet_tpu_torch.train.eval_loop, '
            'pcdet_tpu_torch.models.build, '
            'pcdet_tpu_torch.train.optimization, '
            'pcdet_tpu_torch.train.checkpoint, '
            'pcdet_tpu_torch.train.train_loop, '
            'pcdet_tpu_torch.datasets.kitti.kitti_eval.eval, '
            'pcdet_tpu_torch.datasets.kitti.kitti_eval.native, '
            'pcdet_tpu_torch.datasets.kitti.kitti_eval.kitti_common, '
            'pcdet_tpu_torch.datasets.kitti.kitti_eval.evaluate, '
            'pcdet_tpu_torch.datasets.kitti.kitti_eval_cli, '
            'pcdet_tpu_torch.datasets.kitti.kitti_dataset, '
            'pcdet_tpu_torch.datasets.augmentation.augmentation_utils, '
            'pcdet_tpu_torch.datasets.augmentation.dbsampler, '
            'pcdet_tpu_torch.datasets.dataset, '
            'pcdet_tpu_torch.datasets.loader, '
            'pcdet_tpu_torch.datasets.synthetic, '
            'pcdet_tpu_torch.ops.host_native, '
            'pcdet_tpu_torch.ops.voxelizer, '
            'pcdet_tpu_torch.utils.box_np_ops, '
            'pcdet_tpu_torch.utils.calibration, '
            'pcdet_tpu_torch.utils.object3d, '
            'pcdet_tpu_torch.tools.create_data, '
            'pcdet_tpu_torch.tools.train, '
            'pcdet_tpu_torch.tools.test; '
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pcdet_tpu', 'flax', 'orbax', 'tensorboardX', 'wandb')); "
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT = re.compile(r'^\s*(from|import)\s+pcdet_tpu(\.|\s|$)', re.M)


def test_port_sources_have_no_pcdet_tpu_import():
    sources = sorted((REPO / 'pcdet_tpu_torch').rglob('*.py')) + [
        REPO / 'chip_smoke.py']
    assert len(sources) > 20
    bad = {str(p.relative_to(REPO)): m.group(0).strip()
           for p in sources for m in [_IMPORT.search(p.read_text())] if m}
    assert bad == {}


_OTHER_IMPORT = re.compile(
    r'^\s*(from|import)\s+(flax|orbax|tensorboardX|wandb)(\.|\s|$)', re.M)


def test_port_sources_import_no_flax_orbax_tensorboard_wandb():
    sources = sorted((REPO / 'pcdet_tpu_torch').rglob('*.py')) + [
        REPO / 'chip_smoke.py']
    names = {p.name for p in sources}
    assert {'checkpoint.py', 'train_loop.py', 'build.py'} <= names
    bad = {str(p.relative_to(REPO)): m.group(0).strip()
           for p in sources for m in [_OTHER_IMPORT.search(p.read_text())]
           if m}
    assert bad == {}


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize('name', ['second.yaml', 'pointpillar.yaml'])
def test_config_equals_pcdet_tpu(name):
    got = config.cfg_from_yaml_file(str(CFGS / name))
    want = jax_config.cfg_from_yaml_file(str(CFGS / name))
    assert _plain(got) == _plain(want)
    assert got.MODEL.NAME == want.MODEL.NAME and got.TAG == name[:-5]


@pytest.mark.parametrize('mode,keep', [('uniform', 1.0), ('rings', 0.35)])
def test_make_scene_equals_pcdet_tpu(mode, keep):
    for seed in (0, 5):
        got = synthetic.make_scene(np.random.RandomState(seed),
                                   ['Car', 'Pedestrian', 'Cyclist'],
                                   num_objects=9, ground_mode=mode,
                                   ring_keep=keep)
        want = jax_synthetic.make_scene(np.random.RandomState(seed),
                                        ['Car', 'Pedestrian', 'Cyclist'],
                                        num_objects=9, ground_mode=mode,
                                        ring_keep=keep)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _coords(cfg, points, mask, train):
    det = detect.build_detector(cfg, 'cpu')
    if train:
        det.max_voxels = int(cfg.DATA_CONFIG.TRAIN.MAX_NUMBER_OF_VOXELS)
    vox = det.voxelize(torch.as_tensor(points), torch.as_tensor(mask))
    return det.model, vox['coordinates'].numpy(), vox['voxel_mask'].numpy()


def _second_scans():
    cfg = config.cfg_from_yaml_file(str(CFGS / 'second.yaml'))
    points, mask, gt = make_train_scans(cfg, 2, ring_keep=0.35)
    return cfg, points, mask, gt


@pytest.fixture(scope='module')
def second():
    return _second_scans()


def _tiny_scans():
    cfg = tiny_second_cfg(num_class=3)
    rng = np.random.RandomState(0)
    p = int(cfg.DATA_CONFIG.MAX_POINTS)
    points = np.zeros((2, p, 4), np.float32)
    mask = np.zeros((2, p), bool)
    for i in range(2):
        pts, _, _ = synthetic.make_scene(rng, list(cfg.CLASS_NAMES),
                                         num_objects=6, x_range=(3, 30),
                                         y_range=(-14, 14))
        n = min(len(pts), p)
        points[i, :n], mask[i, :n] = pts[:n], True
    return cfg, points, mask


@pytest.mark.parametrize('which,train', [('tiny', False), ('tiny', True),
                                         ('second', False), ('second', True)])
def test_host_books_equal_pcdet_tpu(second, which, train):
    if which == 'tiny':
        cfg, points, mask = _tiny_scans()
    else:
        cfg, points, mask, _ = second
    model, coords, vmask = _coords(cfg, points, mask, train)
    spec = model.host_book_spec(coords.shape[1], train)
    assert host_books.native_lib() is not None, host_books.native_error()
    got = host_books.build_books_batch(coords, vmask, model.sparse_shape, spec)
    want = jax_books.build_books_batch(coords, vmask, model.sparse_shape, spec)
    assert list(got) == list(want) and len(got) == 6 * 4 + 2 * 4
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['hb_spconv2_msk'].sum() > 0
    if which == 'tiny':
        # the numpy builders give pcdet_tpu's numpy bits, and the native
        # books wherever a tap is found (a miss's row is arbitrary)
        slow = host_books.build_books_batch_np(coords, vmask,
                                               model.sparse_shape, spec)
        per = [jax_books.pack_books(jax_books.build_books_sample(
            coords[i], vmask[i], model.sparse_shape, spec)) for i in range(2)]
        for k in want:
            np.testing.assert_array_equal(
                slow[k], np.stack([p[k] for p in per]), err_msg=k)
        cap = coords.shape[1]
        dec = [host_books.upload_books(f, spec, cap, 'cpu')
               for f in (slow, got)]
        for k in dec[0]:
            a, b = dec[0][k], dec[1][k]
            for x, y in zip(*((a, b) if isinstance(a, tuple) else
                              ((a,), (b,)))):
                assert torch.equal(x, y), k


@pytest.mark.parametrize('which', ['tiny', 'second'])
def test_anchor_targets_equal_pcdet_tpu(second, which):
    if which == 'tiny':
        cfg = tiny_second_cfg(num_class=3)
        rng = np.random.RandomState(3)
        gts = []
        for _ in range(2):
            pts, boxes, names = synthetic.make_scene(
                rng, list(cfg.CLASS_NAMES), num_objects=7, x_range=(3, 30),
                y_range=(-14, 14))
            gt = np.zeros((10, 8), np.float32)
            gt[:7, :7] = boxes
            gt[:7, 7] = [list(cfg.CLASS_NAMES).index(n) + 1 for n in names]
            gts.append(gt)
        gts.append(np.zeros((10, 8), np.float32))       # no boxes at all
    else:
        cfg, _, _, gts = second
    dc = cfg.DATA_CONFIG
    grid = np.asarray(grid_size(tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE),
                                tuple(dc.POINT_CLOUD_RANGE)))
    target_cfg = cfg.MODEL.RPN.RPN_HEAD.TARGET_CONFIG
    got = AnchorHeadTargets(target_cfg, grid, list(cfg.CLASS_NAMES))
    want = JaxTargets(target_cfg, grid, list(cfg.CLASS_NAMES))
    np.testing.assert_array_equal(got.anchors, want.anchors)
    assert got.num_anchors_per_location == want.num_anchors_per_location
    positives = 0
    for gt in gts:
        a, b = got.assign(gt), want.assign(gt)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        positives += int((a['labels'] > 0).sum())
    assert positives > 0


def _eval_boxes(rng, n):
    return np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                     rng.uniform(0.5, 5.0, n), rng.uniform(0.5, 5.0, n),
                     rng.uniform(-np.pi, np.pi, n)], axis=1)


def _image_boxes(rng, n):
    lo = rng.uniform(0, 100, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(1, 60, (n, 2))], axis=1)


@pytest.mark.parametrize('name', ['voxelizer_native.cpp',
                                  'augmentation_native.cpp'])
def test_data_native_sources_equal_pcdet_tpu(name):
    assert ((REPO / 'pcdet_tpu_torch' / 'csrc' / name).read_bytes()
            == (REPO / 'pcdet_tpu' / 'native' / name).read_bytes())


def test_data_native_functions_equal_pcdet_tpu():
    assert jax_native.get_lib() is not None
    rng = np.random.RandomState(9)
    pts = rng.uniform(-5, 35, (5000, 4)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 30, (20, 3)),
                            rng.uniform(1, 5, (20, 3)),
                            rng.uniform(-3, 3, (20, 1))], 1).astype(np.float32)
    got = host_native.points_in_rbboxes(pts, boxes)
    np.testing.assert_array_equal(got, jax_native.points_in_rbboxes(pts,
                                                                    boxes))
    assert got.dtype == bool and got.sum() > 20
    b5 = boxes[:, [0, 1, 3, 4, 6]]
    valid = rng.rand(20) < 0.9
    loc = rng.normal(0, 1, (20, 50, 3)).astype(np.float32)
    rot = rng.uniform(-0.8, 0.8, (20, 50)).astype(np.float32)
    sel = host_native.noise_per_box(b5, valid, loc, rot)
    np.testing.assert_array_equal(sel, jax_native.noise_per_box(b5, valid,
                                                                loc, rot))
    assert sel.dtype == np.int64 and (sel >= 0).sum() > 5
    for cap in (20000, 300):
        args = ([0.4, 0.4, 0.5], [0, -20, -3], [100, 100, 8], 8, cap)
        got = host_native.voxelize(pts, *args)
        want = jax_native.voxelize(pts, *args)
        assert got['num_voxels'] == want['num_voxels']
        n = got['num_voxels']
        for k in ('voxels', 'coordinates', 'num_points_per_voxel',
                  'voxel_pt_indices_into_original_pt_cloud'):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k][:n], want[k][:n],
                                          err_msg=k)


def test_kitti_eval_native_equals_pcdet_tpu():
    assert jax_native.get_lib() is not None
    rng = np.random.RandomState(7)
    a, b = _eval_boxes(rng, 40), _eval_boxes(rng, 33)
    for criterion in (-1, 0, 1, 2):
        got = native.rotate_iou_eval(a, b, criterion)
        np.testing.assert_array_equal(
            got, jax_native.rotate_iou_eval(a, b, criterion))
    assert (got > 0).sum() > 20
    ia, ib = _image_boxes(rng, 30), _image_boxes(rng, 25)
    for criterion in (-1, 0, 1):
        np.testing.assert_array_equal(
            native.image_box_overlap(ia, ib, criterion),
            jax_native.image_box_overlap(ia, ib, criterion))

    # matching statistics: 3 frames of detections vs GT, ignore flags of
    # every kind, DontCare boxes, with and without false positives and aos
    frames = []
    for _ in range(3):
        nd, ng, ndc = rng.randint(5, 12), rng.randint(3, 9), rng.randint(0, 3)
        frames.append({
            'overlaps': rng.uniform(0, 1, (nd, ng)),
            'gt': np.concatenate([_image_boxes(rng, ng),
                                  rng.uniform(-3, 3, (ng, 1))], axis=1),
            'dt': np.concatenate([_image_boxes(rng, nd),
                                  rng.uniform(-3, 3, (nd, 1)),
                                  rng.uniform(0, 1, (nd, 1))], axis=1),
            'igt': rng.randint(-1, 2, ng).astype(np.int64),
            'idt': rng.randint(-1, 2, nd).astype(np.int64),
            'dc': _image_boxes(rng, ndc)})
    for f in frames:
        for fp, aos in ((False, False), (True, False), (True, True)):
            for metric in (0, 1):
                args = (f['overlaps'], f['gt'], f['dt'], f['igt'], f['idt'],
                        f['dc'], metric, 0.5, 0.3, fp, aos)
                got = native.compute_statistics(*args)
                want = jax_native.compute_statistics(*args)
                assert got[:4] == want[:4]
                np.testing.assert_array_equal(got[4], want[4])
    total_gt = sum(f['overlaps'].shape[1] for f in frames)
    parted = np.zeros((sum(f['overlaps'].shape[0] for f in frames), total_gt))
    r = c = 0
    for f in frames:
        nd, ng = f['overlaps'].shape
        parted[r:r + nd, c:c + ng] = f['overlaps']
        r, c = r + nd, c + ng
    thresholds = np.sort(rng.uniform(0, 1, 6))
    prs = []
    for lib in (native, jax_native):
        pr = np.zeros((len(thresholds), 4))
        lib.fused_compute_statistics(
            parted, pr, np.array([f['overlaps'].shape[1] for f in frames]),
            np.array([f['overlaps'].shape[0] for f in frames]),
            np.array([len(f['dc']) for f in frames]),
            np.concatenate([f['gt'] for f in frames]),
            np.concatenate([f['dt'] for f in frames]),
            np.concatenate([f['dc'] for f in frames]),
            np.concatenate([f['igt'] for f in frames]),
            np.concatenate([f['idt'] for f in frames]), 0, 0.5, thresholds,
            compute_aos=True)
        prs.append(pr)
    np.testing.assert_array_equal(prs[0], prs[1])
    assert prs[0][:, 0].sum() > 0


def _annos_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize('which', ['tiny', 'second'])
def test_synthetic_dataset_equals_pcdet_tpu(which):
    if which == 'tiny':
        cfg = tiny_second_cfg(num_class=3)
        cfg.DATA_CONFIG.SYNTHETIC = {'NUM_SAMPLES': 3, 'NUM_OBJECTS': 9}
    else:
        cfg = config.cfg_from_yaml_file(str(CFGS / 'second.yaml'))
        cfg.DATA_CONFIG.SYNTHETIC = {
            'NUM_SAMPLES': 2, 'NUM_OBJECTS': 24, 'GROUND_MODE': 'rings',
            'PTS_PER_OBJ': 400, 'RING_KEEP': 0.35}
    got = synthetic.SyntheticDataset(cfg, seed=4)
    jcfg = copy.deepcopy(cfg)
    jcfg.TORCH_VOXEL_GENERATOR = True      # the device voxelizer's layout
    want = jax_synthetic.SyntheticDataset(jcfg, training=False, seed=4)
    assert len(got) == len(want)
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g['sample_idx'] == w['sample_idx']
        for k in ('points', 'point_mask', 'gt_boxes'):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g['point_mask'].sum() > 0 and g['gt_boxes'][:, 7].max() > 0
    _annos_equal(got.gt_annos(), want.gt_annos())
    batch = next(synthetic.eval_batches(got, 2))
    rng = np.random.RandomState(1)
    preds = {'boxes': rng.uniform(0.5, 3, (2, 20, 7)).astype(np.float32),
             'scores': rng.rand(2, 20).astype(np.float32),
             'labels': rng.randint(1, 4, (2, 20)).astype(np.int32),
             'valid': rng.rand(2, 20) > 0.3}
    names = list(cfg.CLASS_NAMES)
    _annos_equal(got.generate_annotations(batch, preds, names),
                 want.generate_annotations(batch, preds, names))
