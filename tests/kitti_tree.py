"""A fabricated KITTI-format tree for the port's data pipeline tests:
`tests/test_kitti_dataset.py:_make_kitti_tree`'s frames (one car each on
ground clutter, camera labels, calib, road planes, a 1242 x 375 PNG),
split 4 train / 2 val, with its configs at the tiny widths."""
import copy
import os

from tiny_config import tiny_parta2_cfg

from test_kitti_dataset import _kitti_cfg, _make_kitti_tree

N_TRAIN, N_VAL = 4, 2


def make_tree(root):
    """Write the tree under `root` (6 frames, 4 train, 2 val)."""
    ids = _make_kitti_tree(root, n_frames=N_TRAIN + N_VAL)
    with open(os.path.join(root, 'ImageSets', 'train.txt'), 'w') as f:
        f.write('\n'.join(ids[:N_TRAIN]) + '\n')
    with open(os.path.join(root, 'ImageSets', 'val.txt'), 'w') as f:
        f.write('\n'.join(ids[N_TRAIN:]) + '\n')
    return ids


def kitti_cfg(root, parta2=False):
    """The tiny PointPillar KITTI config of `test_kitti_dataset` over the
    tree (DB sampling with road planes, per-object and global noise on);
    with `parta2`, the Part-A² backbone's per-voxel targets as well."""
    cfg = _kitti_cfg(root)
    if parta2:
        cfg.MODEL.RPN.BACKBONE = copy.deepcopy(
            tiny_parta2_cfg(num_class=3).MODEL.RPN.BACKBONE)
    return cfg


def create_infos(root, cfg=None):
    """The info pickles and GT database, by `pcdet_tpu`'s create_kitti_infos."""
    from pcdet_tpu.datasets.kitti.kitti_dataset import create_kitti_infos
    create_kitti_infos(cfg or kitti_cfg(root), data_path=root, save_path=root,
                       workers=2)


def assert_equal(got, want, path='example'):
    """Bit-for-bit equality of nested dicts / lists of numpy arrays and
    scalars, dtypes included."""
    import numpy as np
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (
            path, sorted(got), sorted(want))
        for k in want:
            assert_equal(got[k], want[k], '%s[%r]' % (path, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal(g, w, '%s[%d]' % (path, i))
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)
