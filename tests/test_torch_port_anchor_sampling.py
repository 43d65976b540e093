"""The positive-fraction anchor sampling (SAMPLE_POS_FRACTION >= 0) of the
port's `models/anchors.py` against `pcdet_tpu.models.anchors`, on the
shipped `tools/cfgs/second.yaml` anchor config (200 x 176 cells, 3
classes, 211,200 anchors) with SAMPLE_POS_FRACTION 0.5 and SAMPLE_SIZE
512: each class keeps at most 256 positives (the rest drawn without
replacement become -1) and draws 512 less its positives negatives, with
replacement, from `np.random`.  Under the same `np.random` seed the labels,
`bbox_targets`, `bbox_src_targets` and outside weights equal `pcdet_tpu`'s
bit for bit: on a scene of a few boxes (under the quota), on a crowded
scene whose Car positives exceed the quota, and with no GT boxes.
"""
import copy
from pathlib import Path

import numpy as np
import pytest

from pcdet_tpu.models.anchors import AnchorHeadTargets as JaxTargets
from pcdet_tpu_torch import config
from pcdet_tpu_torch.datasets import synthetic
from pcdet_tpu_torch.models.anchors import AnchorHeadTargets
from pcdet_tpu_torch.ops.voxelizer import grid_size

CFG = Path(__file__).resolve().parent.parent / 'tools' / 'cfgs' / 'second.yaml'
KEYS = ('labels', 'bbox_targets', 'bbox_src_targets', 'bbox_outside_weights')


@pytest.fixture(scope='module')
def targets():
    """(the config, {'plain': (port, pcdet_tpu) targets at
    SAMPLE_POS_FRACTION -1, 'sampled': at 0.5 of 512})."""
    cfg = config.cfg_from_yaml_file(str(CFG))
    dc = cfg.DATA_CONFIG
    grid = np.asarray(grid_size(tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE),
                                tuple(dc.POINT_CLOUD_RANGE)))
    names = list(cfg.CLASS_NAMES)
    base = cfg.MODEL.RPN.RPN_HEAD.TARGET_CONFIG
    sampled = copy.deepcopy(base)
    sampled.SAMPLE_POS_FRACTION = 0.5
    sampled.SAMPLE_SIZE = 512
    return cfg, {
        'plain': (AnchorHeadTargets(base, grid, names),
                  JaxTargets(base, grid, names)),
        'sampled': (AnchorHeadTargets(sampled, grid, names),
                    JaxTargets(sampled, grid, names))}


def _scene(cfg, num_objects, seed):
    """(M, 8) GT rows [box, class 1..3] of a `make_scene` scene, padded
    with zero rows to MAX_GT_BOXES."""
    names = list(cfg.CLASS_NAMES)
    _, boxes, gt_names = synthetic.make_scene(
        np.random.RandomState(seed), names, num_objects=num_objects,
        x_range=(3, 65), y_range=(-38, 38))
    gt = np.zeros((max(int(cfg.DATA_CONFIG.MAX_GT_BOXES), num_objects), 8),
                  np.float32)
    gt[:len(boxes), :7] = boxes
    gt[:len(boxes), 7] = [names.index(n) + 1 for n in gt_names]
    return gt


def _assign_both(pair, gt, seed):
    """Both packages' targets for `gt`, each from np.random seeded alike."""
    out = []
    for t in pair:
        np.random.seed(seed)
        out.append(t.assign(gt))
    return out


def _class_slices(t):
    """The flat anchor indices of each class (classes concatenate on the
    per-location axis)."""
    per = [len(d['matched_thresholds']) // int(np.prod(t.feature_map_size))
           for d in t.anchors_dict.values()]
    loc = np.arange(t.num_anchors) % sum(per)
    edges = np.cumsum([0] + per)
    return [(loc >= a) & (loc < b) for a, b in zip(edges[:-1], edges[1:])]


@pytest.mark.parametrize('case,num_objects', [
    ('under the quota', 6), ('positives past the quota', 160),
    ('no GT boxes', 0)])
def test_sampled_targets_equal_pcdet_tpu(targets, case, num_objects):
    cfg, pairs = targets
    gt = _scene(cfg, num_objects, seed=4)
    port, jax_targets = pairs['sampled']
    got, want = _assign_both((port, jax_targets), gt, seed=11)
    assert sorted(got) == sorted(want)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # what the case claims: the positives before sampling against the quota
    plain = pairs['plain'][0].assign(gt)
    quota = int(0.5 * 512)
    per_class = [int((plain['labels'][m] > 0).sum())
                 for m in _class_slices(port)]
    kept = [int((got['labels'][m] > 0).sum()) for m in _class_slices(port)]
    negatives = [int((got['labels'][m] == 0).sum())
                 for m in _class_slices(port)]
    if case == 'no GT boxes':
        assert sum(per_class) == 0 and sum(kept) == 0
    elif case == 'under the quota':
        assert 0 < max(per_class) <= quota and kept == per_class
    else:
        assert per_class[0] > quota and kept[0] == quota
        assert all(min(p, quota) == k for p, k in zip(per_class, kept))
    # the negatives drawn with replacement: at most 512 less the positives
    for k, n in zip(kept, negatives):
        assert 0 < n <= 512 - k
    assert int((got['labels'] == -1).sum()) > 0
    np.testing.assert_array_equal(got['bbox_outside_weights'],
                                  (got['labels'] > 0).astype(np.float32))


def test_sampling_draws_from_np_random(targets):
    """Another seed draws other negatives; the same seed the same ones; an
    explicit `rng` replaces np.random."""
    cfg, pairs = targets
    port = pairs['sampled'][0]
    gt = _scene(cfg, 6, seed=4)
    np.random.seed(1)
    a = port.assign(gt)['labels']
    np.random.seed(1)
    b = port.assign(gt)['labels']
    np.random.seed(2)
    c = port.assign(gt)['labels']
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    d = next(iter(port.anchors_dict.values()))
    flat = d['anchors'].reshape(-1, 7)
    names = np.array(port.class_names)[gt[:6, 7].astype(int) - 1]
    mask = names == port.class_names[0]
    args = (flat, gt[:6, :7][mask], gt[:6, 7][mask].astype(np.int32),
            d['matched_thresholds'], d['unmatched_thresholds'],
            d['near_bbox'], d['grid'], 0.5, 512)
    one = port.assigner.create_target_np(*args,
                                         rng=np.random.RandomState(3))
    two = port.assigner.create_target_np(*args,
                                         rng=np.random.RandomState(3))
    np.testing.assert_array_equal(one['labels'], two['labels'])
