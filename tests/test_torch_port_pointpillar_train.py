"""pcdet_tpu_torch PointPillar training vs pcdet_tpu (CPU,
tiny_pointpillar_cfg with 3 classes, B=2).

The same flax variables (random, with random BN statistics) and the same
scans go through `pcdet_tpu.models.pointpillar.PointPillar` (voxelize_jnp
at the train cap, `assign` targets, `jax.value_and_grad` of `loss ∘
forward(train=True)`; `make_train_step` with the adam_onecycle chain) and
through the port's trainer (`train.trainer.build_trainer(cfg, 'cpu')`,
`make_batch`, `step`):

- BatchNorm with a (B, V, P) mask on a (B, V, P, C) input reduces over the
  live voxels' point rows, padded slots included (`n` = live voxels x P),
  as pcdet_tpu's TorchBatchNorm does, to 1e-6;
- the PFN's train forward (one and two layers) to 1e-5 of its largest
  value (the batch statistics sum 64,000 point rows in another order) and
  its BN running statistics to 1e-5;
- the scatter's feature gradient against JAX's VJP of `pillar_scatter` to
  1e-6 (padding voxels get 0);
- loss and every tb term to 1e-5 relative; the new BN running statistics
  to 1e-5;
- every gradient leaf to 1e-4 of its largest value against the JAX model
  run in f64 (jax.enable_x64, f64 variables and inputs, its f32
  `preferred_element_type` requests dropped for f64 operands), and the
  port run in f64 to 1e-6 of max against it.  JAX's own f32 gradients are
  no reference at this tolerance: XLA's f32 reductions (the BN statistics
  over sparse canvases, whose small variances amplify them) put them up to
  4.4e-3 of max from its f64 result, where the port's f32 lies within
  2e-6; the port must lie at least as close as they do;
- the loss over 3 optimizer steps to 1e-4 relative.

Also: eval detect is unchanged, bit for bit, by a train_mode() /
eval_mode() round trip, and the bf16 eval canvas and convs do not reach
training.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_config import tiny_pointpillar_cfg

from pcdet_tpu.datasets.synthetic import make_scene
from pcdet_tpu.models.layers import TorchBatchNorm
from pcdet_tpu.models.pillar_scatter import pillar_scatter as jax_scatter
from pcdet_tpu.models.pointpillar import PointPillar as JaxPointPillar
from pcdet_tpu.models.vfe import PillarFeatureNet as JaxPFN
from pcdet_tpu.ops.voxelizer import voxelize_jnp
from pcdet_tpu.train import optimization as jax_opt
from pcdet_tpu.train import train_state as jax_train
from pcdet_tpu_torch import detect
from pcdet_tpu_torch.models.layers import BatchNorm
from pcdet_tpu_torch.models.pillar_scatter import pillar_scatter
from pcdet_tpu_torch.models.vfe import PillarFeatureNet
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


def _layer_nums(cfg):
    return cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']


def _trainer(cfg, variables):
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=TOTAL_STEPS)
    trainer.model.module.load_state_dict(state_dict_from_flax(
        variables, _layer_nums(cfg)))
    return trainer


def _jax_f64_grads(jmodel, variables, jbatch):
    """The JAX model's loss gradient, computed in f64."""
    real_conv, real_dot = jax.lax.conv_general_dilated, jnp.dot

    def f64_ok(fn):
        def call(*args, preferred_element_type=None, **kw):
            if args[0].dtype == jnp.float64:
                preferred_element_type = None
            return fn(*args, preferred_element_type=preferred_element_type,
                      **kw)
        return call

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax.lax, 'conv_general_dilated', f64_ok(real_conv))
        mp.setattr(jnp, 'dot', f64_ok(real_dot))
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        jb = {k: jnp.asarray(np.asarray(v)) for k, v in jbatch.items()}
        jb = {k: v.astype(jnp.float64) if v.dtype == jnp.float32 else v
              for k, v in jb.items()}

        def loss_fn(params):
            ret, _ = jmodel.forward({'params': params,
                                     'batch_stats': v64['batch_stats']},
                                    jb, train=True)
            return jmodel.loss(ret, jb)[0]

        grads = jax.grad(loss_fn)(v64['params'])
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                      grads)


def _voxelize(cfg, points, mask):
    dc = cfg.DATA_CONFIG
    vs = tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE)
    pr = tuple(dc.POINT_CLOUD_RANGE)
    cap = int(dc.TRAIN.MAX_NUMBER_OF_VOXELS)
    return jax.vmap(lambda q, m: voxelize_jnp(
        q, m, vs, pr, int(dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL), cap))(
            jnp.asarray(points), jnp.asarray(mask))


@pytest.fixture(scope='module')
def run():
    cfg = tiny_pointpillar_cfg(num_class=3)
    points, mask, gt = _scans(cfg)
    dc = cfg.DATA_CONFIG
    jmodel = JaxPointPillar(cfg, grid_size(
        tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE), tuple(dc.POINT_CLOUD_RANGE)))
    vox = _voxelize(cfg, points, mask)
    jbatch = {'voxels': vox['voxels'],
              'num_points': vox['num_points_per_voxel'],
              'coordinates': vox['coordinates'],
              'voxel_mask': vox['voxel_mask']}
    template = jax.eval_shape(
        lambda: jmodel.init_variables(jax.random.PRNGKey(0), jbatch))
    variables = _random_variables(template, 1)

    trainer = _trainer(cfg, variables)
    vfe = copy.deepcopy(trainer.model.module.vfe)        # before any step
    batch = trainer.make_batch(torch.as_tensor(points), torch.as_tensor(mask),
                               gt)
    targets = [jmodel.anchor_targets.assign(g) for g in gt]
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
            'batch': batch, 'trainer': trainer, 'vfe': vfe,
            'want': (loss, stats, tb, grads),
            'got': (got_loss, got_tb, got_grads)}


def test_batchnorm_point_mask_reduces_over_live_voxel_rows():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 5, 6).astype(np.float32) * 2 + 1
    vmask = rng.rand(2, 7) < 0.6
    rows = np.broadcast_to(vmask[..., None], (2, 7, 5))
    stats = {'mean': rng.randn(6).astype(np.float32),
             'var': rng.uniform(0.5, 2, 6).astype(np.float32)}
    params = {'scale': rng.uniform(0.5, 1.5, 6).astype(np.float32),
              'bias': rng.randn(6).astype(np.float32)}
    want, upd = TorchBatchNorm(6).apply(
        {'params': params, 'batch_stats': stats}, jnp.asarray(x), True,
        mask=jnp.asarray(rows), mutable=['batch_stats'])
    bn = BatchNorm(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(params['scale']))
        bn.bias.copy_(torch.as_tensor(params['bias']))
        bn.running_mean.copy_(torch.as_tensor(stats['mean']))
        bn.running_var.copy_(torch.as_tensor(stats['var']))
        got = bn(torch.as_tensor(x), mask=torch.as_tensor(rows.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    for key, buf in (('mean', bn.running_mean), ('var', bn.running_var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(upd['batch_stats'][key]),
                                   rtol=0, atol=1e-6)
    # f64 numpy: the statistics over every point row of the live voxels
    live = x[vmask].reshape(-1, 6).astype(np.float64)
    n = vmask.sum() * 5
    assert live.shape[0] == n
    mean, var = live.mean(0), live.var(0)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.99 * stats['mean'] + 0.01 * mean, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.99 * stats['var']
                               + 0.01 * var * n / (n - 1), atol=1e-6)


@pytest.mark.parametrize('filters', [(32,), (16, 32)])
def test_pfn_train_forward_and_statistics_match_jax(run, filters):
    cfg = run['cfg']
    jb = run['jbatch']
    dc = cfg.DATA_CONFIG
    args = dict(voxel_size=tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE),
                pc_range=tuple(dc.POINT_CLOUD_RANGE))
    inputs = (jb['voxels'], jb['num_points'], jb['coordinates'],
              jb['voxel_mask'])
    jvfe = JaxPFN(num_filters=filters, **args)
    template = jax.eval_shape(lambda: jvfe.init(jax.random.PRNGKey(0),
                                                *inputs, False))
    variables = _random_variables(template, 5)
    want, upd = jvfe.apply(variables, *inputs, True, mutable=['batch_stats'])
    vfe = PillarFeatureNet(num_filters=filters, **args).train()
    sd = {}
    for i in range(len(filters)):
        p = variables['params']['PFNLayer_%d' % i]
        s = variables['batch_stats']['PFNLayer_%d' % i]['TorchBatchNorm_0']
        key = 'pfn_layers.%d' % i
        sd[key + '.linear.weight'] = torch.as_tensor(
            np.transpose(p['TorchLinear_0']['kernel']))
        for a, b in (('weight', 'scale'), ('bias', 'bias')):
            sd['%s.norm.%s' % (key, a)] = torch.as_tensor(
                p['TorchBatchNorm_0'][b])
        sd[key + '.norm.running_mean'] = torch.as_tensor(s['mean'])
        sd[key + '.norm.running_var'] = torch.as_tensor(s['var'])
        sd[key + '.norm.num_batches_tracked'] = torch.tensor(0)
    vfe.load_state_dict(sd)
    with torch.no_grad():
        got = vfe(*(torch.as_tensor(np.asarray(t)) for t in inputs))
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    for i in range(len(filters)):
        new = upd['batch_stats']['PFNLayer_%d' % i]['TorchBatchNorm_0']
        norm = vfe.pfn_layers[i].norm
        np.testing.assert_allclose(norm.running_mean.numpy(),
                                   np.asarray(new['mean']), rtol=0, atol=1e-5)
        np.testing.assert_allclose(norm.running_var.numpy(),
                                   np.asarray(new['var']), rtol=0, atol=1e-5)


def test_pfn_train_output_of_the_model_matches_jax(run):
    """The model's own PFN (the trainer's, before its step) in train mode
    on the trainer's batch against the JAX model's `vfe` submodule."""
    jmodel, variables, jb = run['jmodel'], run['variables'], run['jbatch']
    m = jmodel.module
    want, upd = JaxPFN(
        num_filters=tuple(m.vfe_num_filters), use_norm=m.use_norm,
        with_distance=m.vfe_with_distance, voxel_size=tuple(m.voxel_size),
        pc_range=tuple(m.pc_range)).apply(
            {'params': variables['params']['vfe'],
             'batch_stats': variables['batch_stats']['vfe']},
            jb['voxels'], jb['num_points'], jb['coordinates'],
            jb['voxel_mask'], True, mutable=['batch_stats'])
    vfe, b = run['vfe'].train(), run['batch']
    with torch.no_grad():
        got = vfe(b['voxels'], b['num_points_per_voxel'], b['coordinates'],
                  b['voxel_mask'])
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    new = upd['batch_stats']['PFNLayer_0']['TorchBatchNorm_0']
    np.testing.assert_allclose(vfe.pfn_layers[0].norm.running_var.numpy(),
                               np.asarray(new['var']), rtol=0, atol=1e-5)


def test_scatter_feature_gradient_matches_jax_vjp(run):
    b, jm = run['batch'], run['jmodel'].module
    coords, vmask = b['coordinates'], b['voxel_mask']
    assert not bool(vmask.all())                  # padding voxels present
    rng = np.random.RandomState(7)
    feats = rng.randn(*vmask.shape, 8).astype(np.float32)
    cot = rng.randn(vmask.shape[0], jm.grid_ny, jm.grid_nx, 8).astype(
        np.float32)
    _, vjp = jax.vjp(lambda f: jax_scatter(
        f, jnp.asarray(coords.numpy()), jnp.asarray(vmask.numpy()),
        jm.grid_ny, jm.grid_nx), jnp.asarray(feats))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    f = torch.as_tensor(feats).requires_grad_(True)
    canvas = pillar_scatter(f, coords, vmask, jm.grid_ny, jm.grid_nx)
    got, = torch.autograd.grad(canvas, f, torch.as_tensor(cot))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert not got[~vmask].any()


def test_batch_matches_the_jax_loader(run):
    b, jb = run['batch'], run['jbatch']
    np.testing.assert_array_equal(b['coordinates'].numpy(),
                                  np.asarray(jb['coordinates']))
    np.testing.assert_array_equal(b['box_cls_labels'].numpy(),
                                  np.asarray(jb['box_cls_labels']))
    np.testing.assert_array_equal(b['box_reg_targets'].numpy(),
                                  np.asarray(jb['box_reg_targets']))
    assert 'books' not in b
    assert (b['box_cls_labels'].numpy() > 0).sum(1).min() > 0


def test_loss_and_tb_match_jax(run):
    loss, _, tb, _ = run['want']
    got_loss, got_tb, _ = run['got']
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    assert sorted(got_tb) == sorted(tb)
    assert 'overflow/voxelizer' in tb and 'rpn_loss_dir' in tb
    for k, v in tb.items():
        np.testing.assert_allclose(float(got_tb[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_every_gradient_matches_jax(run):
    cfg, module = run['cfg'], run['trainer'].model.module
    names = [n for n, _ in module.named_parameters()]
    want = state_dict_from_flax(
        {'params': _jax_f64_grads(run['jmodel'], run['variables'],
                                  run['jbatch'])}, _layer_nums(cfg))
    jax32 = state_dict_from_flax({'params': run['want'][3]}, _layer_nums(cfg))
    assert sorted(want) == sorted(names)
    assert any(n.startswith('vfe.') for n in names)
    trainer64 = _trainer(cfg, run['variables'])
    trainer64.model.module.double()
    trainer64.model.anchors = trainer64.model.anchors.double()
    batch64 = dict(run['batch'])
    for key in ('voxels', 'box_reg_targets'):
        batch64[key] = batch64[key].double()
    _, _, grads64 = train_state.loss_and_grads(
        trainer64.model, trainer64.state.params, batch64)
    for name, g, g64 in zip(names, run['got'][2], grads64):
        w = want[name].numpy().astype(np.float64)
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err / scale)
        assert err <= float(np.abs(jax32[name].numpy() - w).max()) + (
            1e-6 * scale), name
        np.testing.assert_allclose(g64.numpy(), w, rtol=0, atol=1e-6 * scale,
                                   err_msg=name)


def test_bn_running_statistics_match_jax(run):
    stats = run['want'][1]
    want = state_dict_from_flax({'params': run['variables']['params'],
                                 'batch_stats': stats},
                                _layer_nums(run['cfg']))
    got = run['trainer'].model.module.state_dict()
    keys = [k for k in want if k.endswith(('running_mean', 'running_var'))]
    assert len(keys) == 2 * (1 + 6)          # the PFN's + 6 RPN BNs here
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
    """compute_dtype_test (bf16 canvas and RPN) is eval-only: a train
    forward gives the f32 config's loss exactly."""
    cfg = copy.deepcopy(run['cfg'])
    cfg.MODEL.RPN.RPN_HEAD.ARGS['compute_dtype_test'] = 'bfloat16'
    trainer = _trainer(cfg, run['variables'])
    assert trainer.model.module.canvas_dtype == torch.bfloat16
    loss, _, _ = train_state.loss_and_grads(trainer.model,
                                            trainer.state.params, run['batch'])
    assert float(loss) == float(run['got'][0])


def test_detect_unchanged_by_a_train_eval_round_trip(run):
    det = detect.build_detector(run['cfg'], 'cpu', seed=0)
    det.model.module.load_state_dict(state_dict_from_flax(
        run['variables'], _layer_nums(run['cfg'])))
    with torch.no_grad():
        det.model.module.rpn_head.conv_cls.bias.zero_()
    pts, msk = torch.as_tensor(run['points']), torch.as_tensor(run['mask'])
    before = det.detect(pts, msk)
    assert int(before['num'].sum()) > 0
    det.model.train_mode()
    assert det.model.training and det.model.module.vfe.training
    det.model.eval_mode()
    assert not det.model.module.vfe.pfn_layers[0].training
    after = det.detect(pts, msk)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
