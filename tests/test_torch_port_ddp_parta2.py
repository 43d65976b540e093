"""Part-A²'s rank step against the port in one process (CPU, f64, the tiny
Part-A² config with 3 classes, SpConvRCNN pooled at 6³, 16 RoIs a sample,
DP_RATIO 0, a train cap of 600 voxels, a global batch of 2 over two gloo ranks spawned from the
test), in both BatchNorm modes as `test_torch_port_ddp_steps.py` checks
PointPillar and SECOND: the global loss and every tb term to 1e-12
relative, every gradient to 1e-12 of max, the BN running statistics to
1e-12, and after 3 steps both ranks' states bitwise equal.

Both sides sample the same RoIs: a one-process f32 run records its
proposals, with the last 4 slots of each sample on its GT boxes so that fg
RoIs and the regression and corner losses exist, and its sampler picks;
the one-process reference and each rank (its own sample's rows) take
them.  Then the global normalizers matter: the fg RoIs, the valid labels
and the positive voxels are counts over the global batch
(`unet_loss`'s `pos_norm`, `rcnn_loss`'s `cls_valid` and `fg_sum`).
"""
import pytest
import torch

from tiny_config import tiny_parta2_cfg

import ddp_ranks
from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans
from test_torch_port_ddp_steps import (check_against_one_process,
                                       check_ranks_bitwise)

torch.set_num_threads(1)

MODES = ('per_rank', 'sync')


def _cfg():
    cfg = ddp_ranks.port_cfg(tiny_parta2_cfg(num_class=3))
    cfg.DATA_CONFIG.MAX_GT_BOXES = 32
    # the scans' 248 and 478 voxels fit: the UNet's level caps, and so its
    # gather-GEMMs' rows, follow the cap
    cfg.DATA_CONFIG.TRAIN.MAX_NUMBER_OF_VOXELS = 600
    cfg.MODEL.RCNN.DP_RATIO = 0.0
    cfg.MODEL.RCNN.ROI_AWARE_POOL_SIZE = 6
    cfg.MODEL.RCNN.TARGET_CONFIG.ROI_PER_IMAGE = 16
    return cfg


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    cfg = _cfg()
    points, mask, gt = make_train_scans(cfg, 2, num_objects=6)
    base = {'cfg': cfg, 'points': points, 'mask': mask, 'gt': gt,
            'state': build_trainer(cfg, 'cpu', seed=1).model.module
            .state_dict(), 'dtype': 'float64'}
    jobs, want, recorded = {}, {}, {}
    for mode in MODES:
        groups = 2 if mode == 'per_rank' else 1
        rec = ddp_ranks.step_job(dict(base, dtype='float32', record=True),
                                 bn_groups=groups)
        recorded[mode] = rec['sampler']
        jobs[mode] = dict(base, sync_bn=mode == 'sync',
                          inject=rec['inject'])
        want[mode] = ddp_ranks.step_job(jobs[mode], bn_groups=groups)
    got = ddp_ranks.run_ranks(tmp_path_factory.mktemp('ddp_parta2'),
                              ddp_ranks.step_rank,
                              [dict(jobs[m], steps=3) for m in MODES])
    return {m: ([g[i] for g in got], want[m], recorded[m])
            for i, m in enumerate(MODES)}


@pytest.mark.parametrize('mode', MODES)
def test_rank_step_equals_one_process(runs, mode):
    got, want, recorded = runs[mode]
    # fg RoIs in both samples, a regression loss on them
    assert (recorded['fg_count'] > 0).all()
    assert want['tb']['rcnn_loss_reg'] > 0 and want['tb'][
        'rcnn_loss_corner'] > 0
    assert want['tb']['rpn_pos_num'] > 0
    assert want['tb']['overflow/voxelizer'] == 0
    check_against_one_process(got, want)
    for r in got:
        assert torch.equal(r['sampler']['fg_count'],
                           want['sampler']['fg_count'][[got.index(r)]])


@pytest.mark.parametrize('mode', MODES)
def test_ranks_hold_one_state_after_three_steps(runs, mode):
    check_ranks_bitwise(runs[mode][0])
