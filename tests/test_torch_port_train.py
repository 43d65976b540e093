"""pcdet_tpu_torch SECOND training vs pcdet_tpu, the slice as a whole (CPU,
tiny_second_cfg with 3 classes, B=2).

The same flax variables (random, with random BN statistics) and the same
scans go through `pcdet_tpu.models.second.SECONDNet` (voxelize_jnp at the
train cap, host books at the train caps, `assign` targets,
`jax.value_and_grad` of `loss ∘ forward(train=True)`; `make_train_step`
with the adam_onecycle chain) and through the port's trainer
(`train.trainer.build_trainer(cfg, 'cpu')`, `make_batch`, `step`):

- loss and every tb term to 1e-5 relative;
- every gradient leaf to 1e-4 of its largest value (the sparse convs' dW
  sums thousands of rows in another order);
- the new BN running statistics to 1e-5;
- the loss over 3 optimizer steps to 1e-4 relative.

Also: eval detect after a train_mode() / eval_mode() round trip gives what
it gave before, and the bf16 eval dtypes do not reach training.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_config import tiny_second_cfg

from pcdet_tpu.datasets.synthetic import make_scene
from pcdet_tpu.models.second import SECONDNet as JaxSECONDNet
from pcdet_tpu.ops import host_books as jax_books
from pcdet_tpu.ops.voxelizer import voxelize_jnp
from pcdet_tpu.train import optimization as jax_opt
from pcdet_tpu.train import train_state as jax_train
from pcdet_tpu_torch import detect
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.train import train_state
from pcdet_tpu_torch.train.trainer import build_trainer
from pcdet_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

TOTAL_STEPS = 10
CLASSES = ['Car', 'Pedestrian', 'Cyclist']


def _scans(cfg):
    rng = np.random.RandomState(0)
    p = int(cfg.DATA_CONFIG.MAX_POINTS)
    g = int(cfg.DATA_CONFIG.MAX_GT_BOXES)
    points = np.zeros((2, p, 4), np.float32)
    mask = np.zeros((2, p), bool)
    gt = np.zeros((2, g, 8), np.float32)
    for i in range(2):
        pts, boxes, names = make_scene(rng, CLASSES, num_objects=6,
                                       x_range=(3, 30), y_range=(-14, 14))
        n = min(len(pts), p)
        points[i, :n], mask[i, :n] = pts[:n], True
        gt[i, :len(boxes), :7] = boxes
        gt[i, :len(boxes), 7] = [CLASSES.index(x) + 1 for x in names]
    return points, mask, gt


def _random_variables(template, seed):
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], 'key', '')
        if name == 'kernel':
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


def _trainer(cfg, variables):
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=TOTAL_STEPS)
    trainer.model.module.load_state_dict(state_dict_from_flax(
        variables, cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']))
    return trainer


@pytest.fixture(scope='module')
def run():
    cfg = tiny_second_cfg(num_class=3)
    points, mask, gt = _scans(cfg)
    dc = cfg.DATA_CONFIG
    vs = tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE)
    pr = tuple(dc.POINT_CLOUD_RANGE)
    cap = int(dc.TRAIN.MAX_NUMBER_OF_VOXELS)
    jmodel = JaxSECONDNet(cfg, grid_size(vs, pr))
    vox = jax.vmap(lambda q, m: voxelize_jnp(
        q, m, vs, pr, int(dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL), cap))(
            jnp.asarray(points), jnp.asarray(mask))
    jbatch = {'voxels': vox['voxels'],
              'num_points': vox['num_points_per_voxel'],
              'coordinates': vox['coordinates'],
              'voxel_mask': vox['voxel_mask']}
    template = jax.eval_shape(
        lambda: jmodel.init_variables(jax.random.PRNGKey(0), jbatch))
    variables = _random_variables(template, 1)

    trainer = _trainer(cfg, variables)
    batch = trainer.make_batch(torch.as_tensor(points), torch.as_tensor(mask),
                               gt)
    flat = jax_books.build_books_batch(
        np.asarray(vox['coordinates']), np.asarray(vox['voxel_mask']),
        jmodel.sparse_shape, jmodel.host_book_spec(cap, True))
    targets = [jmodel.anchor_targets.assign(g) for g in gt]
    jbatch.update({k: jnp.asarray(v) for k, v in flat.items()})
    jbatch['box_cls_labels'] = jnp.asarray(np.stack(
        [t['labels'] for t in targets]).astype(np.int32))
    jbatch['box_reg_targets'] = jnp.asarray(np.stack(
        [t['bbox_targets'] for t in targets]).astype(np.float32))
    jbatch['voxel_overflow'] = jnp.asarray(batch['voxel_overflow'].numpy())

    def loss_fn(params):
        ret, stats = jmodel.forward(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jbatch, train=True)
        loss, tb = jmodel.loss(ret, jbatch)
        return loss, (stats, tb)

    (loss, (stats, tb)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'])
    got_loss, got_tb, got_grads = train_state.loss_and_grads(
        trainer.model, trainer.state.params, batch)
    return {'cfg': cfg, 'jmodel': jmodel, 'variables': variables,
            'points': points, 'mask': mask, 'gt': gt, 'jbatch': jbatch,
            'batch': batch, 'trainer': trainer,
            'want': (loss, stats, tb, grads),
            'got': (got_loss, got_tb, got_grads)}


def test_batch_matches_the_jax_loader(run):
    b, jb = run['batch'], run['jbatch']
    np.testing.assert_array_equal(b['coordinates'].numpy(),
                                  np.asarray(jb['coordinates']))
    np.testing.assert_array_equal(b['box_cls_labels'].numpy(),
                                  np.asarray(jb['box_cls_labels']))
    np.testing.assert_array_equal(b['box_reg_targets'].numpy(),
                                  np.asarray(jb['box_reg_targets']))
    assert (b['box_cls_labels'].numpy() > 0).sum(1).min() > 0


def test_loss_and_tb_match_jax(run):
    loss, _, tb, _ = run['want']
    got_loss, got_tb, _ = run['got']
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    assert sorted(got_tb) == sorted(tb)
    assert 'overflow/conv2' in tb and 'overflow/voxelizer' in tb
    for k, v in tb.items():
        np.testing.assert_allclose(float(got_tb[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_every_gradient_matches_jax(run):
    grads = run['want'][3]
    module = run['trainer'].model.module
    names = [n for n, _ in module.named_parameters()]
    want = state_dict_from_flax({'params': grads},
                                run['cfg'].MODEL.RPN.RPN_HEAD.ARGS[
                                    'layer_nums'])
    assert sorted(want) == sorted(names)
    for name, g in zip(names, run['got'][2]):
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_bn_running_statistics_match_jax(run):
    stats = run['want'][1]
    want = state_dict_from_flax({'params': run['variables']['params'],
                                 'batch_stats': stats},
                                run['cfg'].MODEL.RPN.RPN_HEAD.ARGS[
                                    'layer_nums'])
    got = run['trainer'].model.module.state_dict()
    keys = [k for k in want if k.endswith(('running_mean', 'running_var'))]
    assert len(keys) == 2 * (12 + 6)         # 12 sparse + 6 RPN BNs here
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_three_steps_match_make_train_step(run):
    cfg, variables = run['cfg'], run['variables']
    tx, _ = jax_opt.build_optimizer_and_schedule(
        cfg.MODEL.TRAIN.OPTIMIZATION, TOTAL_STEPS, 1)
    step = jax_train.make_train_step(run['jmodel'], tx, donate=False)
    state = jax_train.create_train_state(variables, tx)
    trainer = _trainer(cfg, variables)
    batch = trainer.make_batch(torch.as_tensor(run['points']),
                               torch.as_tensor(run['mask']), run['gt'])
    want, got = [], []
    for _ in range(3):
        state, tb = step(state, run['jbatch'])
        want.append(float(tb['loss']))
        got.append(float(trainer.step(batch)['loss']))
    assert trainer.state.step == 3 and trainer.state.optimizer.count == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(set(want)) == 3


def test_train_mode_ignores_the_bf16_eval_dtypes(run):
    """compute_dtype_test (bf16 sparse stack and RPN) is eval-only: a train
    forward gives the f32 config's loss exactly."""
    cfg = copy.deepcopy(run['cfg'])
    cfg.MODEL.RPN.BACKBONE.ARGS['compute_dtype_test'] = 'bfloat16'
    cfg.MODEL.RPN.RPN_HEAD.ARGS['compute_dtype_test'] = 'bfloat16'
    trainer = _trainer(cfg, run['variables'])
    assert trainer.model.module.compute_dtype is None
    loss, _, _ = train_state.loss_and_grads(trainer.model,
                                            trainer.state.params, run['batch'])
    assert float(loss) == float(run['got'][0])
    trainer.model.eval_mode()
    assert trainer.model.module.compute_dtype == torch.bfloat16


def test_detect_unchanged_by_a_train_eval_round_trip(run):
    det = detect.build_detector(run['cfg'], 'cpu', seed=0)
    det.model.module.load_state_dict(state_dict_from_flax(
        run['variables'], run['cfg'].MODEL.RPN.RPN_HEAD.ARGS['layer_nums']))
    with torch.no_grad():
        det.model.module.rpn_head.conv_cls.bias.zero_()
    pts, msk = torch.as_tensor(run['points']), torch.as_tensor(run['mask'])
    before = det.detect(pts, msk)
    assert int(before['num'].sum()) > 0
    det.model.train_mode()
    assert det.model.training
    det.model.eval_mode()
    after = det.detect(pts, msk)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
