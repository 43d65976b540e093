"""W gloo ranks of the port, W = 2 and 4, against `pcdet_tpu`'s
single-device step on the same global batch (CPU, f32, the tiny
PointPillar and SECOND configs with 3 classes, a global batch of W, one
scan a rank, the same random flax variables through
`weights.state_dict_from_flax`), with `pcdet_tpu`'s per-device BatchNorm,
`set_bn_groups(W)`, against each rank's own statistics, at the tolerances
of `tests/test_torch_port_train.py`:

- the global loss (the ranks' shares summed) to 1e-5 relative and every
  tb term (summed over the ranks) to 1e-5;
- every gradient (summed over the ranks, on both ranks) within 1e-4 of
  its largest value: SECOND's against JAX's f32 gradients, PointPillar's
  against the JAX model run in f64, as `tests/test_torch_port_pointpillar_
  train.py` holds the one-process step (XLA's f32 reductions put JAX's own
  f32 PointPillar gradients up to 4.4e-3 of max off);
- the BN running statistics, rank 0's (JAX's group 0) on every rank, to
  1e-5.
`set_bn_groups` is set inside the test: the conftest's fixture resets it
to 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_config import tiny_pointpillar_cfg, tiny_second_cfg

import ddp_ranks
from pcdet_tpu.models import layers as jax_layers
from pcdet_tpu.models.pointpillar import PointPillar as JaxPointPillar
from pcdet_tpu.models.second import SECONDNet as JaxSECONDNet
from pcdet_tpu.ops import host_books as jax_books
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.train.trainer import build_trainer
from pcdet_tpu_torch.weights import state_dict_from_flax
from test_torch_port_pointpillar_train import _jax_f64_grads, _voxelize
from test_torch_port_train import (CLASSES, _random_variables, _scans,
                                   make_scene)

torch.set_num_threads(1)

MODELS = {'pointpillar': (tiny_pointpillar_cfg, JaxPointPillar),
          'second': (tiny_second_cfg, JaxSECONDNet)}
# (model, W) cases; W = 2 keeps the ids it had before W = 4 came
CASES = pytest.mark.parametrize('name,world', [
    ('pointpillar', 2), ('second', 2), ('pointpillar', 4), ('second', 4)],
    ids=['pointpillar', 'second', 'pointpillar-w4', 'second-w4'])


def _global_scans(cfg, world):
    """`_scans`' two scenes at W = 2; at W = 4 two more from the same
    random stream."""
    if world == 2:
        return _scans(cfg)
    rng = np.random.RandomState(0)
    p = int(cfg.DATA_CONFIG.MAX_POINTS)
    g = int(cfg.DATA_CONFIG.MAX_GT_BOXES)
    points = np.zeros((world, p, 4), np.float32)
    mask = np.zeros((world, p), bool)
    gt = np.zeros((world, g, 8), np.float32)
    for i in range(world):
        pts, boxes, names = make_scene(rng, CLASSES, num_objects=6,
                                       x_range=(3, 30), y_range=(-14, 14))
        n = min(len(pts), p)
        points[i, :n], mask[i, :n] = pts[:n], True
        gt[i, :len(boxes), :7] = boxes
        gt[i, :len(boxes), 7] = [CLASSES.index(x) + 1 for x in names]
    return points, mask, gt


def _jax_step(name, world):
    """pcdet_tpu's step on the global batch of `world` scans under
    set_bn_groups(world): its loss, tb, new BN statistics and gradients
    (in f64 for PointPillar), and the rank job of the same inputs."""
    make_cfg, jax_cls = MODELS[name]
    cfg = make_cfg(num_class=3)
    points, mask, gt = _global_scans(cfg, world)
    dc = cfg.DATA_CONFIG
    jmodel = jax_cls(cfg, grid_size(tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE),
                                    tuple(dc.POINT_CLOUD_RANGE)))
    vox = _voxelize(cfg, points, mask)
    jbatch = {'voxels': vox['voxels'],
              'num_points': vox['num_points_per_voxel'],
              'coordinates': vox['coordinates'],
              'voxel_mask': vox['voxel_mask']}
    template = jax.eval_shape(
        lambda: jmodel.init_variables(jax.random.PRNGKey(0), jbatch))
    variables = _random_variables(template, 1)
    layer_nums = cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']
    state = state_dict_from_flax(variables, layer_nums)
    batch = build_trainer(cfg, 'cpu').make_batch(
        torch.as_tensor(points), torch.as_tensor(mask), gt)
    if name == 'second':
        cap = int(dc.TRAIN.MAX_NUMBER_OF_VOXELS)
        flat = jax_books.build_books_batch(
            np.asarray(vox['coordinates']), np.asarray(vox['voxel_mask']),
            jmodel.sparse_shape, jmodel.host_book_spec(cap, True))
        jbatch.update({k: jnp.asarray(v) for k, v in flat.items()})
    targets = [jmodel.anchor_targets.assign(g) for g in gt]
    jbatch['box_cls_labels'] = jnp.asarray(np.stack(
        [t['labels'] for t in targets]).astype(np.int32))
    jbatch['box_reg_targets'] = jnp.asarray(np.stack(
        [t['bbox_targets'] for t in targets]).astype(np.float32))
    jbatch['voxel_overflow'] = jnp.asarray(batch['voxel_overflow'].numpy())

    jax_layers.set_bn_groups(world)
    try:
        def loss_fn(params):
            ret, stats = jmodel.forward(
                {'params': params, 'batch_stats': variables['batch_stats']},
                jbatch, train=True)
            loss, tb = jmodel.loss(ret, jbatch)
            return loss, (stats, tb)

        (loss, (stats, tb)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables['params'])
        if name == 'pointpillar':
            grads = _jax_f64_grads(jmodel, variables, jbatch)
    finally:
        jax_layers.set_bn_groups(1)
    want = {'loss': float(loss),
            'tb': {k: float(v) for k, v in tb.items()},
            'grads': state_dict_from_flax({'params': grads}, layer_nums),
            'stats': {k: v for k, v in state_dict_from_flax(
                {'params': variables['params'], 'batch_stats': stats},
                layer_nums).items()
                if k.endswith(('running_mean', 'running_var'))}}
    job = {'cfg': ddp_ranks.port_cfg(cfg), 'state': state, 'points': points,
           'mask': mask, 'gt': gt}
    return want, job


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """runs(W) -> {model: (each rank's result, pcdet_tpu's)}, W ranks
    spawned once for both models."""
    done = {}

    def get(world):
        if world not in done:
            pairs = {name: _jax_step(name, world) for name in sorted(MODELS)}
            got = ddp_ranks.run_ranks(
                tmp_path_factory.mktemp('ddp_jax_w%d' % world),
                ddp_ranks.step_rank, [job for _, job in pairs.values()],
                world=world)
            done[world] = {name: ([g[i] for g in got], pairs[name][0])
                           for i, name in enumerate(pairs)}
        return done[world]
    return get


@CASES
def test_loss_and_tb_match_jax(runs, name, world):
    got, want = runs(world)[name]
    assert len(got) == world
    for r in got:
        np.testing.assert_allclose(r['loss'], want['loss'], rtol=1e-5)
        assert sorted(r['tb']) == sorted(want['tb'])
        assert 'overflow/voxelizer' in r['tb']
        for k, v in want['tb'].items():
            np.testing.assert_allclose(r['tb'][k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    assert len({r['share'] for r in got}) == world


@CASES
def test_every_gradient_matches_jax(runs, name, world):
    got, want = runs(world)[name]
    for r in got:
        assert sorted(r['grads']) == sorted(want['grads'])
        for n, w in want['grads'].items():
            w = w.numpy().astype(np.float64)
            scale = float(np.abs(w).max())
            assert scale > 0, n
            err = float(np.abs(r['grads'][n].numpy() - w).max())
            assert err <= 1e-4 * scale, (n, err / scale)


@CASES
def test_bn_running_statistics_match_jax(runs, name, world):
    got, want = runs(world)[name]
    assert len(want['stats']) == 2 * (1 + 6 if name == 'pointpillar'
                                      else 12 + 6)
    for r in got:
        for k, w in want['stats'].items():
            np.testing.assert_allclose(r['stats'][k].numpy(), w.numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)
