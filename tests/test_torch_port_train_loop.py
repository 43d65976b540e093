"""pcdet_tpu_torch's epoch loop, optimizers, schedules and checkpoints vs
pcdet_tpu (CPU, tiny configs).

- `adam`, `sgd` and `adam_onecycle` (`train.optimization.
  build_optimizer_and_schedule`), with and without a frozen prefix, against
  the optax chains of `pcdet_tpu.train.optimization.
  build_optimizer_and_schedule` over 5 steps of random gradients (some
  clipped) on random parameters: every parameter to 1e-6 relative, a frozen
  one bitwise unchanged; 'vfe' freezes 'vfe.*' and not 'vfe_extra.*';
- `step_decay_lr_schedule` and `warmup_cosine_lr_schedule` against
  pcdet_tpu's at every step of a grid, to 1e-6 relative;
- `train_loop.train_model` over `trainer.TrainScans` (4 scans, B=2): 2
  epochs of PointPillar and 1 of SECOND, the step count, the checkpoints
  kept under `max_ckpt_save_num`, `latest_checkpoint`;
- resume: 1 epoch, a checkpoint, `restore_train_state` into a trainer of
  other weights, 1 more epoch equals 2 straight epochs bitwise (every
  parameter, buffer, optimizer moment, count and the step);
- the same for Part-A²-fc with dropout on: its generator's state rides
  in the checkpoint;
- a checkpoint whose write was cut (its temporary file left) is never
  listed; `load_params_partial` skips a shape mismatch and logs it;
- a `.pth` of `weights.state_dict_from_flax` restores into a detector
  (`detect.build_detector(cfg, 'cpu', checkpoint=path)`) whose detections
  equal the JAX model's on the same scans (counts, valid, labels exactly;
  boxes and scores 1e-4, as tests/test_torch_port_detect.py holds them).
"""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tiny_config import tiny_parta2_cfg, tiny_pointpillar_cfg, tiny_second_cfg

from pcdet_tpu.datasets.synthetic import make_scene
from pcdet_tpu.models.pointpillar import PointPillar as JaxPointPillar
from pcdet_tpu.ops.voxelizer import voxelize_jnp
from pcdet_tpu.train import optimization as jax_opt
from pcdet_tpu_torch import detect
from pcdet_tpu_torch.models.build import build_network
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.train import checkpoint, optimization
from pcdet_tpu_torch.train.train_loop import train_model
from pcdet_tpu_torch.train.trainer import TrainScans, build_trainer
from pcdet_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)


def _optim_cfg(name):
    cfg = tiny_pointpillar_cfg(1).MODEL.TRAIN.OPTIMIZATION
    cfg.OPTIMIZER = name
    cfg.DECAY_STEP_LIST = [2, 4]
    return cfg


@pytest.mark.parametrize('frozen', [(), ('vfe',)])
@pytest.mark.parametrize('name', ['adam', 'sgd', 'adam_onecycle'])
def test_optimizer_matches_optax(name, frozen):
    cfg = _optim_cfg(name)
    iters, epochs = 1, 10
    tx, lr_sched = jax_opt.build_optimizer_and_schedule(
        cfg, iters, epochs, frozen_prefixes=frozen)
    opt, lr = optimization.build_optimizer_and_schedule(
        cfg, iters, epochs, frozen_prefixes=frozen)
    rng = np.random.RandomState(10)
    shapes = {'vfe': {'w': (3, 4), 'b': (5,)}, 'vfe_extra': {'w': (2, 3)},
              'head': {'k': (4, 2)}}
    params = {m: {k: rng.randn(*s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    names = ['%s.%s' % (m, k) for m, d in shapes.items() for k in d]
    mine = {n: torch.as_tensor(params[n.split('.')[0]][n.split('.')[1]])
            .clone() for n in names}
    start = {n: t.clone() for n, t in mine.items()}
    opt.init(list(mine.items()))
    assert opt.frozen == (['vfe.w', 'vfe.b'] if frozen else [])
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for step, size in enumerate((3.0, 40.0, 0.01, 12.0, 1.0)):
        grads = {m: {k: rng.randn(*s).astype(np.float32) * size
                     for k, s in d.items()} for m, d in shapes.items()}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.as_tensor(grads[n.split('.')[0]][n.split('.')[1]])
                  for n in opt.names])
        assert abs(lr(step) - float(lr_sched(step))) <= 1e-6 * lr(step)
    assert opt.count == 5
    for n in names:
        m, k = n.split('.')
        if n in opt.frozen:
            assert torch.equal(mine[n], start[n]), n
            continue
        assert not torch.equal(mine[n], start[n]), n
        np.testing.assert_allclose(mine[n].numpy(), np.asarray(jp[m][k]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize('name', ['adam', 'sgd', 'adam_onecycle'])
def test_optimizer_state_dict_round_trip(name):
    opt, _ = optimization.build_optimizer_and_schedule(_optim_cfg(name), 1,
                                                       10)
    p = [('a', torch.ones(3)), ('b', torch.zeros(2, 2))]
    opt.init(p)
    opt.step([torch.full((3,), 0.5), torch.full((2, 2), -1.0)])
    other, _ = optimization.build_optimizer_and_schedule(_optim_cfg(name), 1,
                                                         10)
    other.init([(n, t.clone()) for n, t in p])
    other.load_state_dict(opt.state_dict())
    assert other.count == 1
    for slot, tensors in opt.state.items():
        for a, b in zip(tensors, other.state[slot]):
            assert torch.equal(a, b) and a.abs().sum() > 0


def test_step_decay_schedule_matches_jax():
    args = (0.003, [2, 4, 7], 3, 0.1, 1e-5)
    want = jax_opt.step_decay_lr_schedule(*args)
    got = optimization.step_decay_lr_schedule(*args)
    for step in range(25):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    assert got(6) == pytest.approx(3e-4) and got(12) == pytest.approx(3e-5)
    assert got(21) == pytest.approx(1e-5)           # clipped at LR_CLIP


def test_warmup_cosine_schedule_matches_jax():
    want = jax_opt.warmup_cosine_lr_schedule(0.003, 1e-5, 7)
    got = optimization.warmup_cosine_lr_schedule(0.003, 1e-5, 7)
    for step in range(8):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    assert got(7) == pytest.approx(0.003)


class _Hooks:
    def __init__(self):
        self.calls = []

    def before_epoch(self, epoch):
        self.calls.append(('epoch', epoch))

    def after_iter(self, step, tb):
        self.calls.append(('iter', step, float(tb['loss'])))


def _train(cfg, epochs, ckpt_dir, total_epochs=None, seed=0, **kw):
    scans = TrainScans(cfg, 4, 2, seed=3)
    trainer = build_trainer(cfg, 'cpu', seed=seed,
                            iters_each_epoch=len(scans),
                            epochs=total_epochs or epochs)
    hooks = _Hooks()
    state = train_model(trainer, scans, epochs, ckpt_save_dir=ckpt_dir,
                        hooks=hooks, **kw)
    return trainer, state, hooks


def test_train_scans_epoch_order():
    scans = TrainScans(tiny_pointpillar_cfg(1), 5, 2, seed=3)
    assert len(scans) == 2
    orders = []
    for epoch in range(2):
        scans.set_epoch(epoch)
        idx = np.arange(5)
        np.random.RandomState(3 + epoch).shuffle(idx)
        assert scans.indices().tolist() == idx[:4].tolist()
        orders.append(scans.indices().tolist())
        batches = list(scans)
        assert len(batches) == 2 and batches[0][0].shape[0] == 2
        np.testing.assert_array_equal(batches[1][2], scans.gt[idx[2:4]])
    assert orders[0] != orders[1]


@pytest.mark.parametrize('model,epochs', [('pointpillar', 2), ('second', 1)])
def test_train_model_steps_and_checkpoints(tmp_path, model, epochs, caplog):
    cfg = (tiny_pointpillar_cfg(3) if model == 'pointpillar'
           else tiny_second_cfg(3))
    # caps the scans overflow (123 pillars of PointPillar's first one)
    cfg.DATA_CONFIG.TRAIN.MAX_NUMBER_OF_VOXELS = (
        100 if model == 'pointpillar' else 1000)
    logger = logging.getLogger('train_model_test')
    with caplog.at_level(logging.INFO, logger='train_model_test'):
        trainer, state, hooks = _train(cfg, epochs, tmp_path,
                                       max_ckpt_save_num=1, logger=logger,
                                       log_interval=1)
    assert state is trainer.state and state.step == 2 * epochs
    assert state.optimizer.count == 2 * epochs
    assert [c[0] for c in hooks.calls] == (['epoch', 'iter', 'iter']
                                           * epochs)
    assert [c[1] for c in hooks.calls if c[0] == 'iter'] == list(
        range(1, 2 * epochs + 1))
    assert all(np.isfinite(c[2]) for c in hooks.calls if c[0] == 'iter')
    ckpts = checkpoint.list_checkpoints(tmp_path)
    assert [os.path.basename(p) for p in ckpts] == [
        'checkpoint_epoch_%d.pth' % epochs]
    assert checkpoint.latest_checkpoint(tmp_path) == ckpts[-1]
    payload = checkpoint.load_checkpoint(ckpts[-1])
    assert sorted(payload) == ['epoch', 'it', 'model_state',
                               'optimizer_state', 'version']
    assert payload['epoch'] == epochs and payload['it'] == 2 * epochs
    assert 'loss' in caplog.text
    assert 'CAP OVERFLOW overflow/voxelizer' in caplog.text


def test_pruning_is_oldest_first_by_mtime_then_epoch(tmp_path):
    trainer = build_trainer(tiny_pointpillar_cfg(1), 'cpu')
    for epoch in (3, 1, 2):
        checkpoint.save_checkpoint(trainer.state, tmp_path, epoch)
    for epoch, t in ((3, 100.0), (1, 200.0), (2, 200.0)):
        os.utime(checkpoint.checkpoint_path(tmp_path, epoch), (t, t))
    assert [os.path.basename(p) for p in checkpoint.list_checkpoints(
        tmp_path)] == ['checkpoint_epoch_%d.pth' % e for e in (3, 1, 2)]
    checkpoint.save_checkpoint(trainer.state, tmp_path, 4,
                               max_ckpt_save_num=2)
    assert [os.path.basename(p) for p in checkpoint.list_checkpoints(
        tmp_path)] == ['checkpoint_epoch_2.pth', 'checkpoint_epoch_4.pth']


def _tensors(trainer):
    """Every tensor of the training state by name, and its counters."""
    sd = trainer.state.state_dict()
    out = {'model.' + k: v for k, v in sd['model_state'].items()}
    for slot, d in sd['optimizer_state']['state'].items():
        out.update({'opt.%s.%s' % (slot, k): v for k, v in d.items()})
    return out, (sd['it'], sd['optimizer_state']['count'])


def test_resume_equals_straight_epochs_bitwise(tmp_path):
    cfg = tiny_pointpillar_cfg(3)
    straight, _, _ = _train(cfg, 2, tmp_path / 'straight')
    first, _, _ = _train(cfg, 1, tmp_path / 'first', total_epochs=2)
    path = checkpoint.latest_checkpoint(tmp_path / 'first')
    assert os.path.basename(path) == 'checkpoint_epoch_1.pth'
    scans = TrainScans(cfg, 4, 2, seed=3)
    resumed = build_trainer(cfg, 'cpu', seed=1, iters_each_epoch=len(scans),
                            epochs=2)
    _, epoch = checkpoint.restore_train_state(path, resumed.state)
    assert epoch == 1
    live, counts = _tensors(first)
    back, back_counts = _tensors(resumed)
    assert counts == back_counts == (2, 2) and sorted(live) == sorted(back)
    for k in live:
        assert torch.equal(live[k], back[k]), k
    train_model(resumed, scans, 2, start_epoch=epoch)
    want, want_counts = _tensors(straight)
    got, got_counts = _tensors(resumed)
    assert got_counts == want_counts == (4, 4)
    assert sorted(got) == sorted(want)
    assert any(k.endswith('running_var') for k in got)
    assert any(k.startswith('opt.nu.') for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_parta2_resume_equals_straight_epochs_bitwise(tmp_path):
    """Part-A²-fc (dropout 0.3; the sampler and the dropouts draw from the
    trainer's generator): its checkpoint carries the generator's state, so
    1 epoch, a restore into a trainer of another seed and 1 more epoch
    equal 2 straight epochs bit for bit."""
    cfg = tiny_parta2_cfg(1)
    rc = cfg.MODEL.RCNN
    rc.NAME, rc.ROI_AWARE_POOL_SIZE, rc.SHARED_FC = 'FCRCNN', 12, [32, 64, 64]
    straight, _, _ = _train(cfg, 2, tmp_path / 'straight')
    first, _, _ = _train(cfg, 1, tmp_path / 'first', total_epochs=2)
    path = checkpoint.latest_checkpoint(tmp_path / 'first')
    assert 'rng_state' in checkpoint.load_checkpoint(path)
    scans = TrainScans(cfg, 4, 2, seed=3)
    resumed = build_trainer(cfg, 'cpu', seed=1, iters_each_epoch=len(scans),
                            epochs=2)
    _, epoch = checkpoint.restore_train_state(path, resumed.state)
    assert torch.equal(resumed.generator.get_state(),
                       first.generator.get_state())
    train_model(resumed, scans, 2, start_epoch=epoch)
    want, want_counts = _tensors(straight)
    got, got_counts = _tensors(resumed)
    assert got_counts == want_counts == (4, 4)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(resumed.generator.get_state(),
                       straight.generator.get_state())


def test_cut_write_is_never_listed(tmp_path, monkeypatch):
    trainer = build_trainer(tiny_pointpillar_cfg(1), 'cpu')
    checkpoint.save_checkpoint(trainer.state, tmp_path, 1)

    def cut(src, dst):
        raise KeyboardInterrupt('killed mid-write')

    monkeypatch.setattr(checkpoint.os, 'replace', cut)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_checkpoint(trainer.state, tmp_path, 2)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == [
        'checkpoint_epoch_1.pth', 'checkpoint_epoch_2.pth.tmp']
    assert [os.path.basename(p) for p in checkpoint.list_checkpoints(
        tmp_path)] == ['checkpoint_epoch_1.pth']
    assert checkpoint.latest_checkpoint(tmp_path).endswith(
        'checkpoint_epoch_1.pth')
    assert checkpoint.latest_checkpoint(tmp_path / 'none') is None


def test_load_params_partial_skips_shape_mismatch(tmp_path, caplog):
    src = build_trainer(tiny_pointpillar_cfg(3), 'cpu', seed=0)
    path = checkpoint.save_checkpoint(src.state, tmp_path, 5)
    dst = build_network(tiny_pointpillar_cfg(1), grid_size(
        src.voxel_size, src.pc_range), device='cpu',
        generator=torch.Generator().manual_seed(7))
    before = {k: v.clone() for k, v in dst.module.state_dict().items()}
    logger = logging.getLogger('partial_load_test')
    with caplog.at_level(logging.INFO, logger='partial_load_test'):
        skipped, epoch, it = checkpoint.load_params_partial(
            path, dst.module, logger)
    assert (epoch, it) == (5, 0)
    assert sorted(skipped) == sorted([
        'rpn_head.conv_box.weight', 'rpn_head.conv_box.bias',
        'rpn_head.conv_cls.weight', 'rpn_head.conv_cls.bias',
        'rpn_head.conv_dir_cls.weight', 'rpn_head.conv_dir_cls.bias'])
    for k in skipped:
        assert 'Not updated weight %s' % k in caplog.text
    disk = src.model.module.state_dict()
    for k, v in dst.module.state_dict().items():
        assert torch.equal(v, before[k] if k in skipped else disk[k]), k


def test_flax_pth_restores_into_a_detector(tmp_path):
    cfg = tiny_pointpillar_cfg(num_class=1)
    dc = cfg.DATA_CONFIG
    rng = np.random.RandomState(0)
    p = int(dc.MAX_POINTS)
    points = np.zeros((2, p, 4), np.float32)
    mask = np.zeros((2, p), bool)
    for i in range(2):
        pts, _, _ = make_scene(rng, ['Car'], num_objects=4, x_range=(3, 30),
                               y_range=(-14, 14))
        n = min(len(pts), p)
        points[i, :n], mask[i, :n] = pts[:n], True
    vs, pr = tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE), tuple(dc.POINT_CLOUD_RANGE)
    jmodel = JaxPointPillar(cfg, grid_size(vs, pr))
    vox = jax.vmap(lambda q, m: voxelize_jnp(
        q, m, vs, pr, int(dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL),
        int(dc.TEST.MAX_NUMBER_OF_VOXELS)))(jnp.asarray(points),
                                            jnp.asarray(mask))
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init_variables(
        jax.random.PRNGKey(0),
        {'voxels': vox['voxels'], 'num_points': vox['num_points_per_voxel'],
         'coordinates': vox['coordinates'], 'voxel_mask': vox['voxel_mask']}))
    variables = {'params': dict(variables['params']),
                 'batch_stats': dict(variables['batch_stats'])}
    head = dict(variables['params']['rpn_head'])
    # the focal prior keeps every score under SCORE_THRESH: zero the bias
    head['conv_cls'] = {**head['conv_cls'],
                        'bias': np.zeros_like(head['conv_cls']['bias'])}
    variables['params']['rpn_head'] = head
    path = str(tmp_path / 'from_flax.pth')
    torch.save({'epoch': 80, 'it': 0, 'model_state': state_dict_from_flax(
        variables, cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums'])}, path)

    det = detect.build_detector(cfg, 'cpu', seed=5, checkpoint=path)
    ret = jmodel.module.apply(variables, vox['voxels'],
                              vox['num_points_per_voxel'],
                              vox['coordinates'], vox['voxel_mask'], False)
    want = {k: np.asarray(v) for k, v in jmodel.predict(ret).items()}
    got = {k: v.numpy() for k, v in det.detect(
        torch.as_tensor(points), torch.as_tensor(mask)).items()}
    assert (want['num'] > 0).all()
    for k in ('num', 'valid', 'labels'):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ('boxes', 'scores'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        detect.build_detector(cfg, 'cpu', checkpoint=path, state_dict={})
