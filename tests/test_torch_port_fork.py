"""The port's BEVSEG fork layer (`pcdet_tpu_torch.experiments`, the
calibration twin, PointPillar's BEV head and `loss_with_bev`, the hook in
the step) against pcdet_tpu's, on the CPU at the tiny widths:

- the re-voxelization hook's outputs equal pcdet_tpu's bit for bit, at
  the TRAIN and TEST caps, below and past the cap; d(voxel sum) / d points
  equals `jax.grad`'s; a batch without points raises;
- `CalibrationTorch` and `pseudolidar_points_from_depth` within 1e-6
  relative of `CalibrationJnp`, with the depth gradient; `Calibration`'s
  new members equal pcdet_tpu's;
- `BEVSegHead` on carried weights within 1e-5 of max |logits| (the tiny
  grid shrunk, which antialiases, and grown; a bf16 input computed in
  f32); KITTI's 248 x 216 -> 200 x 200 resize alone within 1e-4 of max
  (without antialias it is off by more than 0.1);
- `bev_seg_loss` and its VJP within 1e-6, the IoU scalars exact;
  `Evaluator` and `BEVSegEvalAccumulator` equal; `training_before_epoch`'s
  prefixes;
- a USE_PSEUDOLIDAR + MODE 3dobjdet+bev PointPillar step: the loss and tb
  over two steps of `make_train_step` to 1e-4 relative; every gradient,
  the points' included, against the JAX model in f64 (the port in f64 to
  1e-6 of max, in f32 to 1e-4 of max);
- the step of a loader batch past the TRAIN cap sees pcdet_tpu's in-step
  voxels, not the loader's;
- a SECOND step under the hook, with books from the hook's coords, equal
  to pcdet_tpu's on a scene within its cap (loss and tb to 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tiny_config import tiny_pointpillar_cfg, tiny_second_cfg

from pcdet_tpu import experiments as jax_exp
from pcdet_tpu.config import cfg_preprocess
from pcdet_tpu.models.pointpillar import PointPillar as JaxPointPillar
from pcdet_tpu.models.second import SECONDNet as JaxSECONDNet
from pcdet_tpu.ops import host_books as jax_books
from pcdet_tpu.ops.voxelizer import voxelize_jnp
from pcdet_tpu.train import optimization as jax_opt
from pcdet_tpu.train import train_state as jax_train
from pcdet_tpu.utils import calibration as jax_calib
from pcdet_tpu.utils.metrics import Evaluator as JaxEvaluator
from pcdet_tpu_torch import experiments
from pcdet_tpu_torch.datasets import build_dataloader
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.train import train_state
from pcdet_tpu_torch.train.trainer import build_trainer
from pcdet_tpu_torch.utils import calibration
from pcdet_tpu_torch.utils.metrics import Evaluator
from pcdet_tpu_torch.weights import state_dict_from_flax

from test_kitti_dataset import _write_calib
from test_torch_port_pointpillar_train import _random_variables, _scans

torch.set_num_threads(1)

def _fork_cfg(cfg, mode='3dobjdet+bev'):
    cfg.USE_PSEUDOLIDAR = True
    cfg.MODE = mode
    return cfg_preprocess(cfg)


def _points(rng, b, n):
    pts = np.concatenate([
        rng.uniform(-2, 34, (b, n, 1)), rng.uniform(-18, 18, (b, n, 1)),
        rng.uniform(-4, 2, (b, n, 1)), rng.rand(b, n, 1)],
        axis=2).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, n // 2:] = False
    return pts, mask


def _hook_pair(cfg, pts, mask, train):
    want = jax_exp.between_dataloading_and_feedforward(
        {'points': jnp.asarray(pts), 'point_mask': jnp.asarray(mask)}, cfg,
        train=train)
    got = experiments.between_dataloading_and_feedforward(
        {'points': torch.as_tensor(pts), 'point_mask': torch.as_tensor(mask)},
        cfg, train=train)
    return got, want


@pytest.mark.parametrize('train', [True, False])
@pytest.mark.parametrize('n', [800, 12000])
def test_hook_equals_pcdet_tpu(train, n):
    cfg = _fork_cfg(tiny_pointpillar_cfg(3))
    cfg.DATA_CONFIG.TRAIN.MAX_NUMBER_OF_VOXELS = 1500
    cfg.DATA_CONFIG.TEST.MAX_NUMBER_OF_VOXELS = 1200
    cap = 1500 if train else 1200
    pts, mask = _points(np.random.RandomState(n), 2, n)
    got, want = _hook_pair(cfg, pts, mask, train)
    assert got['voxels'].shape[1] == cap
    for key in ('voxels', 'coordinates', 'voxel_mask',
                'voxel_pt_indices_into_original_pt_cloud'):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(got['num_points_per_voxel'].numpy(),
                                  np.asarray(want['num_points']))
    overflow = got['voxel_overflow'].numpy()
    assert (overflow > 0).any() == (n == 12000)


def test_hook_gradient_equals_jax():
    """d(sum of the voxels' reflectance squared) / d points."""
    cfg = _fork_cfg(tiny_pointpillar_cfg(1))
    pts, mask = _points(np.random.RandomState(0), 2, 4000)

    def jax_sum(p):
        out = jax_exp.between_dataloading_and_feedforward(
            {'points': p, 'point_mask': jnp.asarray(mask)}, cfg, train=True)
        return (out['voxels'][..., 3] ** 2).sum()

    want = np.asarray(jax.grad(jax_sum)(jnp.asarray(pts)))
    p = torch.as_tensor(pts).requires_grad_(True)
    out = experiments.between_dataloading_and_feedforward(
        {'points': p, 'point_mask': torch.as_tensor(mask)}, cfg, train=True)
    (out['voxels'][..., 3] ** 2).sum().backward()
    np.testing.assert_array_equal(p.grad.numpy(), want)
    assert np.abs(want[..., 3]).sum() > 0


def test_hook_feature_fn_and_flags():
    cfg = _fork_cfg(tiny_pointpillar_cfg(1))
    pts, mask = _points(np.random.RandomState(1), 2, 2000)
    batch = {'points': torch.as_tensor(pts),
             'point_mask': torch.as_tensor(mask)}
    scaled = experiments.between_dataloading_and_feedforward(
        batch, cfg, point_feature_fn=lambda p: p * torch.tensor(
            [1.0, 1.0, 1.0, 3.0]), train=True)
    plain = experiments.between_dataloading_and_feedforward(batch, cfg)
    np.testing.assert_array_equal(scaled['coordinates'].numpy(),
                                  plain['coordinates'].numpy())
    np.testing.assert_allclose(scaled['voxels'][..., 3].numpy(),
                               3 * plain['voxels'][..., 3].numpy())
    with pytest.raises(ValueError, match="'points'"):
        experiments.between_dataloading_and_feedforward(
            {'point_mask': batch['point_mask'], 'voxels': 0}, cfg)
    off = tiny_pointpillar_cfg(1)
    assert experiments.between_dataloading_and_feedforward(batch, off) is batch


@pytest.fixture(scope='module')
def calib(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('calib') / 'calib.txt')
    _write_calib(path)
    return calibration.Calibration(path), jax_calib.Calibration(path)


def test_calibration_members_equal_pcdet_tpu(calib):
    got, want = calib
    for k in ('cu', 'cv', 'fu', 'fv', 'tx', 'ty'):
        assert getattr(got, k) == getattr(want, k), k
    rng = np.random.RandomState(2)
    pts = rng.uniform(2, 40, (50, 3)).astype(np.float32)
    for g, w in zip(got.lidar_to_img(pts), want.lidar_to_img(pts)):
        np.testing.assert_array_equal(g, w)
    u, v = rng.uniform(0, 1242, 50), rng.uniform(0, 375, 50)
    d = rng.uniform(2, 40, 50)
    np.testing.assert_array_equal(got.img_to_rect(u, v, d),
                                  want.img_to_rect(u, v, d))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_calibration_torch_and_pseudolidar_lift(calib):
    got_c, want_c = calib
    ct = calibration.CalibrationTorch(got_c, device='cpu')
    cj = jax_calib.CalibrationJnp(want_c)
    rng = np.random.RandomState(3)
    pts = rng.uniform(2, 40, (64, 3)).astype(np.float32)
    t = torch.as_tensor(pts)
    assert _rel(ct.lidar_to_rect(t), cj.lidar_to_rect(jnp.asarray(pts))) \
        <= 1e-6
    assert _rel(ct.rect_to_lidar(t), cj.rect_to_lidar(jnp.asarray(pts))) \
        <= 1e-6
    for g, w in zip(ct.rect_to_img(t), cj.rect_to_img(jnp.asarray(pts))):
        assert _rel(g, w) <= 1e-6

    depth = rng.uniform(5, 45, (60, 120)).astype(np.float32)
    weights = rng.randn(15 * 60, 3).astype(np.float32)

    def jax_lift(d):
        return jax_exp.pseudolidar_points_from_depth(
            d, cj, top_margin_pct=0.25, bottom_margin_pct=0.25, stride=2)

    want_pts = np.asarray(jax_lift(jnp.asarray(depth)))
    d = torch.as_tensor(depth).requires_grad_(True)
    got_pts = experiments.pseudolidar_points_from_depth(
        d, ct, top_margin_pct=0.25, bottom_margin_pct=0.25, stride=2)
    assert got_pts.shape == want_pts.shape == (15 * 60, 3)
    assert _rel(got_pts.detach(), want_pts) <= 1e-6
    (got_pts * torch.as_tensor(weights)).sum().backward()
    want_g = np.asarray(jax.grad(lambda x: (jax_lift(x) * weights).sum())(
        jnp.asarray(depth)))
    assert _rel(d.grad, want_g) <= 1e-6
    assert np.abs(want_g).max() > 0


def _flax_head(c_in, hidden, out_size, seed):
    head = jax_exp.BEVSegHead(num_classes=2, hidden=hidden, out_size=out_size)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.2).astype(np.float32),
        jax.eval_shape(lambda: head.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, c_in)), False)))
    torch_head = experiments.BEVSegHead(c_in, 2, hidden, out_size)
    sd = {}
    for name, key in zip(('Conv_0', 'Conv_1', 'Conv_2'),
                         ('conv1', 'conv2', 'conv_out')):
        p = params['params'][name]
        sd[key + '.weight'] = torch.as_tensor(
            np.transpose(p['kernel'], (3, 2, 0, 1)).copy())
        sd[key + '.bias'] = torch.as_tensor(np.asarray(p['bias']))
    torch_head.load_state_dict(sd)
    return head, params, torch_head


@pytest.mark.parametrize('out_size', [20, 200])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_bev_seg_head_equals_flax(out_size, dtype):
    """The tiny grid's 32 x 32 x 64 features to 20 x 20 (a shrink: the
    antialiased resize) and to 200 x 200; a bf16 input computes in f32."""
    head, params, torch_head = _flax_head(64, 16, out_size, 4)
    x = np.random.RandomState(5).randn(2, 32, 32, 64).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(head.apply(params, jx, False))
    got = torch_head(torch.as_tensor(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == want.shape == (2, out_size, out_size, 2)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_kitti_resize_antialiases_like_jax():
    x = np.random.RandomState(6).randn(1, 2, 248, 216).astype(np.float32)
    want = np.asarray(jax.image.resize(
        jnp.asarray(x).transpose(0, 2, 3, 1), (1, 200, 200, 2),
        method='bilinear')).transpose(0, 3, 1, 2)
    scale = np.abs(want).max()
    got = F.interpolate(torch.as_tensor(x), size=(200, 200), mode='bilinear',
                        align_corners=False, antialias=True).numpy()
    assert np.abs(got - want).max() <= 1e-4 * scale
    plain = F.interpolate(torch.as_tensor(x), size=(200, 200),
                          mode='bilinear', align_corners=False).numpy()
    assert np.abs(plain - want).max() > 0.1


def test_bev_seg_loss_and_vjp_equal_jax():
    rng = np.random.RandomState(7)
    logits = (rng.randn(2, 40, 30, 2) * 2).astype(np.float32)
    gt = (rng.rand(2, 40, 30, 2) > 0.6).astype(np.float32)
    cot = np.float32(1.7)
    want_loss, want_tb = jax_exp.bev_seg_loss(jnp.asarray(logits),
                                              jnp.asarray(gt))
    want_g = np.asarray(jax.grad(lambda x: jax_exp.bev_seg_loss(
        x, jnp.asarray(gt))[0] * cot)(jnp.asarray(logits)))
    x = torch.as_tensor(logits).requires_grad_(True)
    got_loss, got_tb = experiments.bev_seg_loss(x, torch.as_tensor(gt))
    (got_loss * cot).backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-6)
    assert sorted(got_tb) == sorted(want_tb) == [
        'bev_loss', 'iou_cls1', 'iou_cls2', 'miou']
    for k in ('iou_cls1', 'iou_cls2', 'miou'):
        assert float(got_tb[k]) == float(want_tb[k]), k
    assert _rel(x.grad, want_g) <= 1e-6


def test_evaluator_and_accumulator_equal_pcdet_tpu():
    rng = np.random.RandomState(8)
    got, want = Evaluator(4), JaxEvaluator(4)
    for _ in range(3):
        g, p = rng.randint(0, 4, (2, 9, 7)), rng.randint(0, 4, (2, 9, 7))
        got.add_batch(g, p)
        want.add_batch(g, p)
    np.testing.assert_array_equal(got.confusion_matrix,
                                  want.confusion_matrix)
    for name in ('Pixel_Accuracy', 'Pixel_Accuracy_Class',
                 'Mean_Intersection_over_Union',
                 'Frequency_Weighted_Intersection_over_Union', 'class_iou'):
        np.testing.assert_array_equal(getattr(got, name)(),
                                      getattr(want, name)())
    acc, jacc = (experiments.BEVSegEvalAccumulator(2),
                 jax_exp.BEVSegEvalAccumulator(2))
    for _ in range(2):
        logits = rng.randn(2, 20, 20, 2).astype(np.float32)
        gt = (rng.rand(2, 20, 20, 2) > 0.5).astype(np.float32)
        acc.add_batch(torch.as_tensor(logits), torch.as_tensor(gt))
        jacc.add_batch(jnp.asarray(logits), jnp.asarray(gt))
    got_r, want_r = acc.results(), jacc.results()
    assert sorted(got_r) == sorted(want_r)
    for k in want_r:
        assert got_r[k] == want_r[k], k


@pytest.mark.parametrize('inject,train_seg,extra,prefixes', [
    (True, False, None, ('seg_model',)),
    (True, True, None, ()),
    (True, False, ['rpn_head', 'vfe'], ('seg_model', 'rpn_head', 'vfe')),
    (False, False, ['vfe', 'vfe'], ('vfe',))])
def test_training_before_epoch_prefixes(inject, train_seg, extra, prefixes):
    cfg = tiny_pointpillar_cfg(1)
    cfg.INJECT_SEMANTICS = inject
    cfg.TRAIN_SEMANTIC_NETWORK = train_seg
    if extra is not None:
        cfg.MODEL.TRAIN.FREEZE_PARAM_PREFIXES = extra
    assert experiments.training_before_epoch(cfg) == prefixes
    assert jax_exp.training_before_epoch(cfg) == prefixes
    assert experiments.training_before_epoch(cfg, ('a',)) == \
        jax_exp.training_before_epoch(cfg, ('a',))


# ---------------------------------------------------------------------------
# the PointPillar step with the hook and the BEV head
# ---------------------------------------------------------------------------

def _f64_grads(jmodel, variables, jbatch, points):
    """The JAX step's loss gradient by the parameters and the points, in f64
    (the hook, the forward and `loss_with_bev`)."""
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

        def loss_fn(params, pts):
            b = jax_exp.between_dataloading_and_feedforward(
                dict(jb, points=pts), jmodel.cfg, train=True)
            ret, _ = jmodel.forward({'params': params,
                                     'batch_stats': v64['batch_stats']},
                                    b, train=True)
            return jmodel.loss_with_bev(ret, b)[0]

        g_params, g_pts = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(
            v64['params'], jnp.asarray(points, jnp.float64))
        return (jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       g_params), np.asarray(g_pts))


@pytest.fixture(scope='module')
def pp_run():
    cfg = _fork_cfg(tiny_pointpillar_cfg(3))
    points, mask, gt = _scans(cfg)
    dc = cfg.DATA_CONFIG
    vs, pr = tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE), tuple(dc.POINT_CLOUD_RANGE)
    jmodel = JaxPointPillar(cfg, grid_size(vs, pr))
    assert jmodel.with_bev_seg
    vox = jax.vmap(lambda q, m: voxelize_jnp(
        q, m, vs, pr, int(dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL),
        int(dc.TRAIN.MAX_NUMBER_OF_VOXELS)))(jnp.asarray(points),
                                             jnp.asarray(mask))
    init_batch = {'voxels': vox['voxels'],
                  'num_points': vox['num_points_per_voxel'],
                  'coordinates': vox['coordinates'],
                  'voxel_mask': vox['voxel_mask']}
    template = jax.eval_shape(
        lambda: jmodel.init_variables(jax.random.PRNGKey(0), init_batch))
    variables = _random_variables(template, 1)
    assert 'bev_seg_head' in variables['params']
    bev = (np.random.RandomState(9).rand(2, 200, 200, 2) > 0.7).astype(
        np.float32)
    targets = [jmodel.anchor_targets.assign(g) for g in gt]
    jbatch = {'points': points, 'point_mask': mask, 'bev': bev,
              'box_cls_labels': np.stack([t['labels'] for t in targets])
              .astype(np.int32),
              'box_reg_targets': np.stack([t['bbox_targets']
                                           for t in targets])
              .astype(np.float32)}
    return {'cfg': cfg, 'jmodel': jmodel, 'variables': variables,
            'points': points, 'mask': mask, 'gt': gt, 'bev': bev,
            'jbatch': jbatch}


def _pp_trainer(run, dtype=torch.float32):
    cfg = run['cfg']
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=10)
    trainer.model.module.load_state_dict(state_dict_from_flax(
        run['variables'], cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']))
    trainer.model.module.to(dtype)
    return trainer


def _pp_batch(run, trainer, dtype=torch.float32):
    pts = torch.as_tensor(run['points']).to(dtype).requires_grad_(True)
    batch = trainer.make_batch(pts, torch.as_tensor(run['mask']), run['gt'])
    batch['bev'] = torch.as_tensor(run['bev']).to(dtype)
    batch['box_reg_targets'] = batch['box_reg_targets'].to(dtype)
    return batch, pts


def test_pointpillar_fork_steps_match_make_train_step(pp_run):
    cfg, variables = pp_run['cfg'], pp_run['variables']
    tx, _ = jax_opt.build_optimizer_and_schedule(
        cfg.MODEL.TRAIN.OPTIMIZATION, 10, 1)
    step = jax_train.make_train_step(pp_run['jmodel'], tx, donate=False)
    state = jax_train.create_train_state(variables, tx)
    jb = {k: jnp.asarray(v) for k, v in pp_run['jbatch'].items()}
    trainer = _pp_trainer(pp_run)
    batch, _ = _pp_batch(pp_run, trainer)
    assert 'voxels' not in batch and 'points' in batch
    want_losses, got_losses = [], []
    for i in range(2):
        state, want = step(state, jb)
        got = trainer.step(batch)
        want_losses.append(float(want['loss']))
        got_losses.append(float(got['loss']))
        if i == 0:
            assert sorted(got) == sorted(list(want)
                                         + ['overflow/voxelizer'])
            assert 'bev_loss' in want and 'miou' in want
            for k, v in want.items():
                np.testing.assert_allclose(float(got[k]), float(v),
                                           rtol=1e-4, atol=1e-7, err_msg=k)
        batch, _ = _pp_batch(pp_run, trainer)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert want_losses[1] != want_losses[0]


def test_pointpillar_fork_gradients_match_jax_f64(pp_run):
    cfg = pp_run['cfg']
    g_params, g_pts = _f64_grads(pp_run['jmodel'], pp_run['variables'],
                                 pp_run['jbatch'], pp_run['points'])
    layer_nums = cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']
    want = state_dict_from_flax({'params': g_params}, layer_nums)
    assert any(k.startswith('bev_seg_head.') for k in want)
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-4)):
        trainer = _pp_trainer(pp_run, dtype)
        batch, pts = _pp_batch(pp_run, trainer, dtype)
        names = [n for n, _ in trainer.model.module.named_parameters()]
        assert sorted(names) == sorted(want)
        _, _, grads = train_state.loss_and_grads(
            trainer.model, list(trainer.state.params) + [pts], batch)
        for name, g in zip(names + ['points'], grads):
            w = g_pts if name == 'points' else want[name].numpy()
            scale = float(np.abs(w).max())
            assert scale > 0, name
            np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                       atol=tol * scale,
                                       err_msg='%s %s' % (dtype, name))


def test_loader_batch_past_the_cap_steps_on_the_in_step_voxels():
    """The loader keeps the voxels that come first, the in-step voxelizer
    the lowest ids: past the TRAIN cap the step must see the latter, as
    pcdet_tpu's step does."""
    cfg = _fork_cfg(tiny_pointpillar_cfg(3), mode='3dobjdet')
    cfg.DATA_CONFIG.TRAIN.MAX_NUMBER_OF_VOXELS = 300
    ds, loader = build_dataloader(cfg, 2, training=True, num_workers=0)
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=2)
    ds.set_anchor_targets(trainer.model.anchor_targets)
    loader.set_epoch(0)
    batch = next(iter(loader))
    assert (np.asarray(batch['voxel_overflow']) > 0).all()
    want = jax_exp.between_dataloading_and_feedforward(
        {'points': jnp.asarray(batch['points']),
         'point_mask': jnp.asarray(batch['point_mask'])}, cfg, train=True)
    seen = {}
    forward = trainer.model.forward

    def spy(b):
        seen.update(b)
        return forward(b)

    trainer.model.forward = spy
    tb = trainer.step(trainer.upload(batch))
    assert np.isfinite(float(tb['loss']))
    for key in ('voxels', 'coordinates', 'voxel_mask'):
        np.testing.assert_array_equal(seen[key].detach().numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert not np.array_equal(seen['coordinates'].numpy(),
                              batch['coordinates'])
    np.testing.assert_array_equal(seen['voxel_overflow'].numpy(),
                                  np.asarray(batch['voxel_overflow']))


def test_second_step_under_the_hook_equals_pcdet_tpu():
    cfg = _fork_cfg(tiny_second_cfg(3), mode='3dobjdet')
    points, mask, gt = _scans(cfg)
    dc = cfg.DATA_CONFIG
    vs, pr = tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE), tuple(dc.POINT_CLOUD_RANGE)
    cap = int(dc.TRAIN.MAX_NUMBER_OF_VOXELS)
    jmodel = JaxSECONDNet(cfg, grid_size(vs, pr))
    hooked = jax_exp.between_dataloading_and_feedforward(
        {'points': jnp.asarray(points), 'point_mask': jnp.asarray(mask)},
        cfg, train=True)
    assert int(np.asarray(hooked['voxel_mask']).sum(1).max()) < cap
    template = jax.eval_shape(lambda: jmodel.init_variables(
        jax.random.PRNGKey(0), hooked))
    variables = _random_variables(template, 1)
    flat = jax_books.build_books_batch(
        np.asarray(hooked['coordinates']), np.asarray(hooked['voxel_mask']),
        jmodel.sparse_shape, jmodel.host_book_spec(cap, True))
    targets = [jmodel.anchor_targets.assign(g) for g in gt]
    jbatch = {'points': jnp.asarray(points), 'point_mask': jnp.asarray(mask),
              'box_cls_labels': jnp.asarray(np.stack(
                  [t['labels'] for t in targets]).astype(np.int32)),
              'box_reg_targets': jnp.asarray(np.stack(
                  [t['bbox_targets'] for t in targets]).astype(np.float32))}
    jbatch.update({k: jnp.asarray(v) for k, v in flat.items()})

    def loss_fn(params):
        b = jax_exp.between_dataloading_and_feedforward(jbatch, cfg,
                                                        train=True)
        ret, _ = jmodel.forward({'params': params,
                                 'batch_stats': variables['batch_stats']},
                                b, train=True)
        return jmodel.loss(ret, b)

    loss, tb = jax.jit(loss_fn)(variables['params'])
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=10)
    trainer.model.module.load_state_dict(state_dict_from_flax(
        variables, cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']))
    batch = trainer.make_batch(torch.as_tensor(points), torch.as_tensor(mask),
                               gt)
    assert 'voxels' not in batch and 'books' in batch
    got_loss, got_tb, _ = train_state.loss_and_grads(
        trainer.model, trainer.state.params, batch)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    assert sorted(got_tb) == sorted(list(tb) + ['overflow/voxelizer'])
    for k, v in tb.items():
        np.testing.assert_allclose(float(got_tb[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
