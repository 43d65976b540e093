"""The plain reference against the port's plain (CPU) paths, at tiny sizes
in float32: the voxelizer, the anchors and their targets, the head outputs
of PointPillar and SECOND, and a training step's loss and gradients."""
import numpy as np
import pytest
import torch

from benchmark.harness import common, scenes
from benchmark.reference import train as ref_train
from benchmark.reference.anchors import Anchors
from benchmark.reference.net import RefModel
from benchmark.reference.voxel import voxelize
from benchmark.tests import tiny


def _model(config, f32=True):
    """(config name, tiny model dict) of a configuration."""
    conf = common.load_json('configs', config)
    model = tiny.tiny_model(conf['model'])
    if f32:
        model['MODEL']['RPN']['RPN_HEAD']['ARGS']['compute_dtype_test'] = ''
        args = model['MODEL']['RPN']['BACKBONE'].get('ARGS', {})
        args['compute_dtype_test'] = ''
    return config, model


def _scans(model, n=2, seed=9):
    ids = scenes.scene_ids(seed, n, 0)
    pts, msk, gt = scenes.make_pool(ids, model['CLASS_NAMES'],
                                    tiny.TINY_SCENE, 8192, 16)
    return pts, msk, gt


@pytest.mark.parametrize('config', ['pointpillar', 'second'])
def test_head_outputs_match_the_port(config):
    from pcdet_tpu_torch.detect import build_detector
    _, model = _model(config)
    cfg = common.program_cfg(model, config)
    ref = RefModel(model)
    pts, msk, _ = _scans(model)
    params = common.make_weights(ref.spec(), 4, torch.device('cpu'))
    common.calibrate(ref, params, torch.as_tensor(pts), torch.as_tensor(msk))
    det = build_detector(cfg, 'cpu', state_dict=params)
    p, m = torch.as_tensor(pts), torch.as_tensor(msk)
    with torch.no_grad():
        _, ret = det.forward(p, m)
        out = ref.forward(params, p, m)
    b = p.shape[0]
    for key, name, width in (('cls_preds', 'cls', ref.num_class),
                             ('box_preds', 'box', 7),
                             ('dir_cls_preds', 'dir', 2)):
        prog = ret[key].reshape(b, -1, width)
        scale = float(out[name].abs().max())
        assert float((prog - out[name]).abs().max()) <= 1e-4 * scale, key
    anchors = Anchors(model, ref.grid).anchors
    assert np.array_equal(anchors, det.model.anchors.numpy())


def test_voxelizer_matches_the_port():
    from pcdet_tpu_torch.ops.voxelizer import voxelize_torch
    _, model = _model('second')
    ref = RefModel(model)
    pts, msk, _ = _scans(model)
    p, m = torch.as_tensor(pts), torch.as_tensor(msk)
    cap = 700            # below the scans' occupied voxels: the cap bites
    mine = voxelize(p, m, ref.voxel_size, ref.pc_range, ref.max_points, cap)
    port = voxelize_torch(p, m, ref.voxel_size, ref.pc_range,
                          ref.max_points, cap)
    live = port['voxel_mask']
    assert int(live.sum()) == len(mine['coords'])
    assert torch.equal(port['coordinates'][live].long(),
                       mine['coords'][:, 1:])
    assert torch.equal(port['voxels'][live], mine['points'])
    assert min(mine['dropped']) > 0


def test_targets_match_the_port():
    from pcdet_tpu_torch.models.anchors import AnchorHeadTargets
    from pcdet_tpu_torch.config import EDict
    _, model = _model('second')
    ref = RefModel(model)
    _, _, gt = _scans(model, n=3)
    mine = Anchors(model, ref.grid)
    head = EDict(model['MODEL']['RPN']['RPN_HEAD'])
    port = AnchorHeadTargets(head.TARGET_CONFIG, np.asarray(ref.grid),
                             model['CLASS_NAMES'])
    for g in gt:
        lab, reg = mine.targets(g)
        t = port.assign(g)
        assert np.array_equal(lab, t['labels'])
        assert np.array_equal(reg, t['bbox_targets'])
        assert (lab > 0).sum() > 0


def test_train_step_matches_the_port():
    """One step of the port's trainer and of the reference from the same
    weights: loss and every leaf's first gradient."""
    from pcdet_tpu_torch.train.trainer import build_trainer
    config, model = _model('second')
    cfg = common.program_cfg(model, config)
    ref = RefModel(model)
    pts, msk, gt = _scans(model, n=2)
    params = common.make_weights(ref.spec(), 6, torch.device('cpu'))
    tr = build_trainer(cfg, 'cpu', iters_each_epoch=10, epochs=1)
    tr.model.module.load_state_dict(params)
    batch = tr.make_batch(torch.as_tensor(pts), torch.as_tensor(msk), gt)
    loss = float(tr.step(batch)['loss'])
    opt = tr.state.optimizer
    b1 = opt.mom(0)
    prog = {n: m / (1 - b1) for n, m in zip(opt.names, opt.state['mu'])}
    losses, first, _ = ref_train.run_steps(
        ref, Anchors(model, ref.grid), params, [(pts, msk, gt)],
        model['MODEL']['TRAIN']['OPTIMIZATION'], 10)
    assert abs(losses[0] - loss) <= 1e-5 * abs(loss)
    for n, g in first.items():
        scale = max(float(g.abs().max()), 1e-12)
        assert float((prog[n] - g).abs().max()) <= 1e-3 * scale, n
