"""The port's KITTI dataset, info files, GT database and evaluator copies
against pcdet_tpu's, bit for bit (CPU), on two identical fabricated trees
(`kitti_tree.make_tree`: 4 train and 2 val frames):

- `create_kitti_infos`: the info pickles (train, val, trainval), the
  db-info pickle and every GT database file equal;
- `KittiDataset.__getitem__` in training (every augmentation on) and in
  evaluation, key by key, dtypes included;
- `generate_annotations` of the same predictions, and the KITTI result
  files it writes;
- the official and the COCO result strings and dicts of the same
  annotations;
- `kitti_eval_cli` on a result.pkl and `evaluate` (label files against
  result files) print pcdet_tpu's strings;
- the image shape read from the PNG header equals PIL's, at several sizes;
  a file that is not a PNG raises;
- TAG_PTS_WITH_RGB and the 'bev' MODE raise NotImplementedError.
"""
import copy
import filecmp
import os
import pickle
import sys

import numpy as np
import pytest
from PIL import Image

from kitti_tree import assert_equal, kitti_cfg, make_tree

from pcdet_tpu.datasets.kitti import kitti_dataset as jax_kitti
from pcdet_tpu.datasets.kitti import kitti_eval_cli as jax_cli
from pcdet_tpu.datasets.kitti.kitti_eval import eval as jax_eval
from pcdet_tpu.datasets.kitti.kitti_eval import evaluate as jax_evaluate
from pcdet_tpu.models.anchors import AnchorHeadTargets as JaxTargets
from pcdet_tpu_torch.datasets.kitti import kitti_dataset, kitti_eval_cli
from pcdet_tpu_torch.datasets.kitti.kitti_eval import eval as kitti_eval
from pcdet_tpu_torch.datasets.kitti.kitti_eval import evaluate
from pcdet_tpu_torch.models.anchors import AnchorHeadTargets

CLASSES = ['Car', 'Pedestrian', 'Cyclist']
PICKLES = ('kitti_infos_train.pkl', 'kitti_infos_val.pkl',
           'kitti_infos_trainval.pkl', 'kitti_dbinfos_train.pkl')


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """The port's tree and pcdet_tpu's, each through its own
    create_kitti_infos."""
    out = {}
    for name, mod in (('port', kitti_dataset), ('jax', jax_kitti)):
        root = str(tmp_path_factory.mktemp('kitti_' + name))
        make_tree(root)
        mod.create_kitti_infos(kitti_cfg(root), data_path=root,
                               save_path=root, workers=2)
        out[name] = root
    return out


def _load(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def test_create_kitti_infos_equals_pcdet_tpu(trees):
    for name in PICKLES:
        got = _load(os.path.join(trees['port'], name))
        want = _load(os.path.join(trees['jax'], name))
        assert_equal(got, want, name)
    infos = _load(os.path.join(trees['port'], 'kitti_infos_train.pkl'))
    assert len(infos) == 4 and infos[0]['annos']['num_points_in_gt'][0] > 300
    np.testing.assert_array_equal(infos[0]['image']['image_shape'],
                                  [375, 1242])
    db = sorted(os.listdir(os.path.join(trees['port'], 'gt_database')))
    assert db == sorted(os.listdir(os.path.join(trees['jax'], 'gt_database')))
    assert len(db) == 4
    for f in db:
        assert filecmp.cmp(os.path.join(trees['port'], 'gt_database', f),
                           os.path.join(trees['jax'], 'gt_database', f),
                           shallow=False), f


def _datasets(root, training):
    cfg = kitti_cfg(root)
    got = kitti_dataset.KittiDataset(cfg, training=training)
    want = jax_kitti.KittiDataset(cfg, training=training)
    tc = cfg.MODEL.RPN.RPN_HEAD.TARGET_CONFIG
    got.set_anchor_targets(AnchorHeadTargets(tc, got.grid_size, CLASSES))
    want.set_anchor_targets(JaxTargets(tc, want.grid_size, CLASSES))
    for ds in (got, want):
        ds.set_sample_seed(11, 2)
    return got, want


@pytest.mark.parametrize('training', [True, False])
def test_getitem_equals_pcdet_tpu(trees, training):
    got, want = _datasets(trees['port'], training)
    assert len(got) == len(want) == (4 if training else 2)
    for i in range(len(got)):
        g = got[i]
        assert_equal(g, want[i], 'example %d' % i)
        np.testing.assert_array_equal(g['image_shape'], [375, 1242])


def _predictions(ds, rng):
    """Jittered GT and random boxes as predictions of a batch of the val
    frames."""
    n = len(ds)
    boxes = rng.uniform(-3, 3, (n, 6, 7)).astype(np.float32)
    boxes[..., :3] += np.array([20, 0, -1], np.float32)
    boxes[..., 3:6] = np.abs(boxes[..., 3:6]) + 0.5
    labels = rng.randint(1, 4, (n, 6)).astype(np.int32)
    valid = rng.rand(n, 6) > 0.2
    for i, info in enumerate(ds.kitti_infos):
        gt = info['annos']['gt_boxes_lidar']
        boxes[i, :len(gt)] = gt + rng.uniform(-0.1, 0.1, gt.shape)
        labels[i, :len(gt)], valid[i, :len(gt)] = 1, True      # cars
    return {'boxes': boxes, 'scores': rng.rand(n, 6).astype(np.float32),
            'labels': labels, 'valid': valid}


def test_annotations_and_ap_strings_equal_pcdet_tpu(trees, tmp_path,
                                                   monkeypatch):
    got_ds, want_ds = _datasets(trees['port'], False)
    batch = {'batch_size': len(got_ds),
             'sample_idx': np.array([i['point_cloud']['lidar_idx']
                                     for i in got_ds.kitti_infos]),
             'image_shape': np.stack([i['image']['image_shape']
                                      for i in got_ds.kitti_infos])}
    preds = _predictions(got_ds, np.random.RandomState(4))
    got = got_ds.generate_annotations(batch, preds, CLASSES,
                                      save_to_file=True,
                                      output_dir=str(tmp_path / 'port'))
    want = want_ds.generate_annotations(batch, preds, CLASSES,
                                        save_to_file=True,
                                        output_dir=str(tmp_path / 'jax'))
    assert_equal(got, want, 'annos')
    assert sum(a['num_example'] for a in got) > 2
    for f in os.listdir(tmp_path / 'jax'):
        assert filecmp.cmp(tmp_path / 'port' / f, tmp_path / 'jax' / f,
                           shallow=False), f
    result, ap = got_ds.evaluation(copy.deepcopy(got), CLASSES)
    want_result, want_ap = want_ds.evaluation(copy.deepcopy(want), CLASSES)
    assert result == want_result and ap == want_ap
    assert ap['Car_3d_easy'] > 0, result
    gt = [copy.deepcopy(i['annos']) for i in got_ds.kitti_infos]
    coco = kitti_eval.get_coco_eval_result(gt, copy.deepcopy(got), CLASSES)
    # pcdet_tpu passes np.linspace its count as a float, which numpy 2
    # refuses; the port passes an int
    linspace = np.linspace
    monkeypatch.setattr(np, 'linspace',
                        lambda lo, hi, num: linspace(lo, hi, int(num)))
    want_coco = jax_eval.get_coco_eval_result(gt, copy.deepcopy(want),
                                              CLASSES)
    monkeypatch.undo()
    assert coco == want_coco
    assert 'Car coco AP@0.50:0.05:0.95' in coco


def test_eval_clis_print_pcdet_tpu_strings(trees, tmp_path, capsys):
    root = trees['port']
    got_ds, _ = _datasets(root, False)
    ids = [i['point_cloud']['lidar_idx'] for i in got_ds.kitti_infos]
    batch = {'batch_size': len(ids), 'sample_idx': np.array(ids),
             'image_shape': np.stack([i['image']['image_shape']
                                      for i in got_ds.kitti_infos])}
    result_dir = tmp_path / 'data'
    annos = got_ds.generate_annotations(
        batch, _predictions(got_ds, np.random.RandomState(6)), CLASSES,
        save_to_file=True, output_dir=str(result_dir))
    pkl = tmp_path / 'result.pkl'
    with open(pkl, 'wb') as f:
        pickle.dump(annos, f)
    args = ['--pred_infos', str(pkl), '--gt_infos',
            os.path.join(root, 'kitti_infos_val.pkl')]
    kitti_eval_cli.main(args)
    got = capsys.readouterr().out
    saved, sys.argv = sys.argv, ['kitti_eval_cli'] + args
    try:
        jax_cli.main()          # it reads sys.argv
    finally:
        sys.argv = saved
    assert got == capsys.readouterr().out and 'Car AP@0.70' in got
    split = os.path.join(root, 'ImageSets', 'val.txt')
    labels = os.path.join(root, 'training', 'label_2')
    linspace = np.linspace
    for coco in (False, True):
        got = evaluate.evaluate(labels, str(result_dir), split, 'Car', coco)
        with pytest.MonkeyPatch.context() as mp:    # as in the test above
            mp.setattr(np, 'linspace',
                       lambda lo, hi, num: linspace(lo, hi, int(num)))
            want = jax_evaluate.evaluate(labels, str(result_dir), split,
                                         'Car', coco)
        assert got == want and 'Car' in got
    evaluate.main(['--label_path', labels, '--result_path', str(result_dir),
                   '--label_split_file', split, '--coco'])
    assert capsys.readouterr().out.strip() == want.strip()


@pytest.mark.parametrize('size', [(1242, 375), (1, 1), (640, 480),
                                  (70000, 3)])
@pytest.mark.parametrize('mode', ['RGB', 'L'])
def test_png_shape_equals_pil(tmp_path, size, mode):
    path = tmp_path / 'x.png'
    Image.new(mode, size).save(path)
    with Image.open(path) as im:
        w, h = im.size
    got = kitti_dataset.png_shape(str(path))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, [h, w])


def test_png_shape_rejects_other_files(tmp_path):
    path = tmp_path / 'x.jpg'
    Image.new('RGB', (8, 8)).save(path)
    with pytest.raises(ValueError, match='not a PNG'):
        kitti_dataset.png_shape(str(path))


@pytest.mark.parametrize('flag', ['TAG_PTS_WITH_RGB', 'MODE'])
def test_camera_paths_wait_for_their_port(trees, flag):
    cfg = kitti_cfg(trees['port'])
    cfg[flag] = True if flag == 'TAG_PTS_WITH_RGB' else '3dobjdet_bev'
    ds = kitti_dataset.KittiDataset(cfg, training=False)
    with pytest.raises(NotImplementedError, match='queue 1 item 6'):
        ds[0]
