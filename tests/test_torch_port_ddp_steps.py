"""The port's rank step against the port in one process (CPU, f64, the tiny
PointPillar and SECOND configs, 3 classes, a global batch of 2 split over
two gloo ranks spawned from the test, `ddp_ranks.step_rank`):

- each rank with its own BatchNorm statistics against one process with
  `bn_groups=2` (JAX's BN_GROUPS, per-device BN), and BatchNorm synced
  over the ranks (`sync_bn`) against one process with one group: the
  global loss (the ranks' shares summed) and every tb term to 1e-12
  relative, every gradient (summed over the ranks) to 1e-12 of its largest
  value, on both ranks, and the BN running statistics after the broadcast
  of rank 0's, equal on both ranks, to 1e-12;
- after 3 optimizer steps every tensor of both ranks' states (parameters,
  BN buffers, optimizer moments and count, the step) bitwise equal;
- a group of one rank: 3 f32 steps bitwise equal to 3 without a group.
"""
import numpy as np
import pytest
import torch

from tiny_config import tiny_pointpillar_cfg, tiny_second_cfg

import ddp_ranks
from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans

torch.set_num_threads(1)

MODELS = {'pointpillar': tiny_pointpillar_cfg, 'second': tiny_second_cfg}
MODES = ('per_rank', 'sync')


def job(name, mode):
    cfg = ddp_ranks.port_cfg(MODELS[name](num_class=3))
    cfg.DATA_CONFIG.MAX_GT_BOXES = 32
    points, mask, gt = make_train_scans(cfg, 2, num_objects=6)
    state = build_trainer(cfg, 'cpu', seed=1).model.module.state_dict()
    return {'cfg': cfg, 'state': state, 'points': points, 'mask': mask,
            'gt': gt, 'dtype': 'float64', 'sync_bn': mode == 'sync'}


def check_against_one_process(got, want):
    """Rank results `got` (one per rank) against the one-process `want`."""
    for r in got:
        assert abs(r['loss'] - want['loss']) <= 1e-12 * abs(want['loss'])
        assert sorted(r['tb']) == sorted(want['tb'])
        for k, v in want['tb'].items():
            assert abs(r['tb'][k] - v) <= 1e-12 * max(abs(v), 1e-30), k
        assert sorted(r['grads']) == sorted(want['grads'])
        for n, g in want['grads'].items():
            assert ddp_ranks.max_rel_err(r['grads'][n], g) <= 1e-12, n
        for n, s in want['stats'].items():
            assert ddp_ranks.max_rel_err(r['stats'][n], s) <= 1e-12, n
    # the ranks loaded neither jax nor pcdet_tpu
    assert all(r['foreign_modules'] == [] for r in got)
    # both ranks' shares of the loss differ, their sum is the loss
    assert got[0]['share'] != got[1]['share']
    assert abs(got[0]['share'] + got[1]['share'] - want['loss']) <= (
        1e-12 * abs(want['loss']))


def check_ranks_bitwise(got, steps=3):
    (s0, c0), (s1, c1) = got[0]['state'], got[1]['state']
    assert c0 == c1 == (steps, steps)
    assert sorted(s0) == sorted(s1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert got[0]['losses'] == got[1]['losses']
    assert all(np.isfinite(got[0]['losses']))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    jobs = {(name, mode): job(name, mode) for name in MODELS
            for mode in MODES}
    want = {key: ddp_ranks.step_job(j, bn_groups=2 if key[1] == 'per_rank'
                                    else 1)
            for key, j in jobs.items()}
    got = ddp_ranks.run_ranks(
        tmp_path_factory.mktemp('ddp_steps'), ddp_ranks.step_rank,
        [dict(j, steps=3) for j in jobs.values()])
    return {key: ([g[i] for g in got], want[key])
            for i, key in enumerate(jobs)}


@pytest.mark.parametrize('name', sorted(MODELS))
@pytest.mark.parametrize('mode', MODES)
def test_rank_step_equals_one_process(runs, name, mode):
    got, want = runs[(name, mode)]
    check_against_one_process(got, want)


@pytest.mark.parametrize('name', sorted(MODELS))
@pytest.mark.parametrize('mode', MODES)
def test_ranks_hold_one_state_after_three_steps(runs, name, mode):
    check_ranks_bitwise(runs[(name, mode)][0])


def test_bn_modes_differ(runs):
    """Per-rank and synced statistics are different computations: the two
    modes give different losses and running statistics."""
    for name in MODELS:
        a, b = runs[(name, 'per_rank')][1], runs[(name, 'sync')][1]
        assert a['loss'] != b['loss']
        assert any(not torch.equal(a['stats'][k], b['stats'][k])
                   for k in a['stats'])


def test_one_rank_equals_no_group_bit_for_bit(tmp_path):
    """A group of one rank changes nothing: 3 f32 PointPillar steps (its
    channels-last RPN, whose weight gradients the all-reduce returns with
    their strides, so the gradient norm's clip sums in the same order) give
    the state of 3 steps without a group, bit for bit."""
    j = dict(job('pointpillar', 'per_rank'), dtype='float32', steps=3)
    want = ddp_ranks.step_job(j)
    got, = ddp_ranks.run_ranks(tmp_path, ddp_ranks.step_rank, [j], world=1)
    assert got[0]['losses'] == want['losses']
    (s0, c0), (s1, c1) = got[0]['state'], want['state']
    assert c0 == c1 == (3, 3)
    for k in s1:
        assert torch.equal(s0[k], s1[k]), k
