"""pcdet_tpu_torch's device rulebook builders (PCDET_HOST_BOOKS=0) vs
pcdet_tpu and vs the port's host books (CPU).

- `sparse.subm_rules`, `strided_out_set` and `inverse_rules_geometric` on a
  batch of two random levels against `pcdet_tpu.ops.sparse._rules_subm`,
  `_strided_out_set` and `_rules_inverse` per sample, on
  tests/test_rulebook_fuzz.py's kernels, strides and paddings, with caps
  small enough that outputs are dropped: rules (misses at V), ids, coords,
  mask and drops equal;
- `host_books.build_books_device` against the port's host books (native
  builder, uploaded and decoded) for SECOND's and Part-A²'s encoder specs
  at the shipped sparse shape (tools/cfgs/second.yaml, PartA2.yaml), eval
  and train caps, B2: every tensor bitwise;
- tiny SECOND and Part-A² detect and one train step with PCDET_HOST_BOOKS=0
  bitwise equal to the host-books run (books, outputs, loss, every
  parameter after the step); the device-book forward against
  pcdet_tpu's forward with no books (its own device builders) within
  test_torch_port_second.py's / test_torch_port_parta2.py's 1e-4;
- the loader path under =0: `make_batch_transform` gives None,
  `upload_loader_batch` builds the books, equal to the host books, and
  raises without books when the switch is on;
- cfg.TORCH_VOXEL_GENERATOR on SECOND with device books voxelizes a batch
  once (twice with host books: once for the books) and gives the host
  path's coords, books, loss and gradients;
- `inverse_conv3d` without a book (the geometric rules) equal to key reuse
  bitwise, forward and gradients, at Part-A²'s three inverse geometries;
- `sparse_maxpool3d` and `SparseBottleneck` (weights carried by
  `weights.state_dict_from_flax`) against pcdet_tpu's;
- `utils.torch_common.points_in_boxes` / `ops.roiaware_pool.
  points_in_boxes_batch` against `jnp_common` / `roiaware_pool`.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_parta2 import _close, _random_variables, _scans
from tiny_config import tiny_parta2_cfg, tiny_second_cfg

from pcdet_tpu.models import backbones3d as jax_bb
from pcdet_tpu.models.parta2 import PartA2Net as JaxPartA2Net
from pcdet_tpu.models.second import SECONDNet as JaxSECONDNet
from pcdet_tpu.ops import roiaware_pool as jax_pool
from pcdet_tpu.ops import sparse as jax_sparse
from pcdet_tpu.ops.voxelizer import voxelize_jnp
from pcdet_tpu.utils import jnp_common
from pcdet_tpu_torch import config, detect, experiments, weights
from pcdet_tpu_torch.models.backbones3d import SparseBottleneck
from pcdet_tpu_torch.ops import host_books, roiaware_pool, sparse
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.train import train_state
from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans
from pcdet_tpu_torch.utils import torch_common

torch.set_num_threads(1)

TOL = 1e-4
SHAPE = (7, 12, 14)


# ------------------------------------------------------------- builders ---

def _level_np(seed, v=80, frac=0.6, shape=SHAPE):
    """One sample's sorted ids, coords and mask (tests/test_rulebook_fuzz.py's
    `_level`, numpy)."""
    rng = np.random.RandomState(seed)
    n = int(v * frac)
    ids = np.full((v,), sparse.INT_MAX, np.int64)
    ids[:n] = np.sort(rng.choice(np.prod(shape), n, replace=False))
    mask = np.arange(v) < n
    plane = shape[1] * shape[2]
    coords = np.where(mask[:, None], np.stack(
        [ids // plane, ids % plane // shape[2], ids % shape[2]], -1), -1)
    return ids.astype(np.int32), coords.astype(np.int32), mask


def _levels(seeds, v=80, shape=SHAPE):
    """A batch of levels for the port and each sample's for JAX."""
    per = [_level_np(s, v, frac, shape)
           for s, frac in zip(seeds, (0.6, 0.45))]
    ids, coords, mask = (np.stack(x) for x in zip(*per))
    port = sparse.SparseLevel(None, torch.as_tensor(ids),
                              torch.as_tensor(coords), torch.as_tensor(mask),
                              shape)
    jax_levels = [jax_sparse.SparseLevel(
        jnp.zeros((v, 1)), jnp.asarray(i), jnp.asarray(c), jnp.asarray(m),
        shape) for i, c, m in per]
    return port, jax_levels


def _jax_rules(rows, found, n_in):
    return np.where(np.asarray(found), np.asarray(rows), n_in)


SUBM = [(1, 1, 1), (3, 3, 3), (5, 5, 5), (1, 3, 3)]
STRIDED = [((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
           ((3, 1, 1), (2, 1, 1), (0, 0, 0)), ((2, 2, 2), (2, 2, 2), (0, 0, 0))]
CASES = ([('subm', k) for k in SUBM] + [('strided', g) for g in STRIDED]
         + [('inverse', g) for g in STRIDED])


@pytest.mark.parametrize('seed', range(2))
@pytest.mark.parametrize('kind,geometry', CASES)
def test_builders_match_pcdet_tpu(kind, geometry, seed):
    port, jax_levels = _levels((seed, seed + 50))
    v = port.ids.shape[1]
    if kind == 'subm':
        got = sparse.subm_rules(port, geometry)
        for i, lv in enumerate(jax_levels):
            want = _jax_rules(*jax_sparse._rules_subm(lv, geometry), v)
            np.testing.assert_array_equal(got[i].numpy(), want)
        assert (got < v).sum() >= int(port.mask.sum())
        return
    kernel, stride, padding = geometry
    if kind == 'strided':
        cap = 16
        ids, coords, mask, dropped, rules = sparse.strided_out_set(
            port, kernel, stride, padding, cap)
        assert ids.dtype == torch.int32 and coords.dtype == torch.int32
        assert rules.dtype == torch.int32 and dropped.dtype == torch.int32
        for i, lv in enumerate(jax_levels):
            w_ids, w_coords, w_mask, _, w_drop, w_rows, w_found = \
                jax_sparse._strided_out_set(lv, kernel, stride, padding, cap)
            np.testing.assert_array_equal(ids[i].numpy(), np.asarray(w_ids))
            np.testing.assert_array_equal(coords[i].numpy(),
                                          np.asarray(w_coords))
            np.testing.assert_array_equal(mask[i].numpy(), np.asarray(w_mask))
            assert int(dropped[i]) == int(w_drop)
            np.testing.assert_array_equal(rules[i].numpy(),
                                          _jax_rules(w_rows, w_found, v))
        assert (dropped > 0).all(), dropped
        return
    coarse_shape = sparse.conv_out_shape(SHAPE, kernel, stride, padding)
    coarse, jax_coarse = _levels((seed + 100, seed + 150), v=48,
                                 shape=coarse_shape)
    got = sparse.inverse_rules_geometric(coarse, port, kernel, stride,
                                         padding)
    for i, lv in enumerate(jax_levels):
        want = _jax_rules(*jax_sparse._rules_inverse(
            jax_coarse[i], lv.coords, lv.mask, kernel, stride, padding), 48)
        np.testing.assert_array_equal(got[i].numpy(), want)
    assert (got < 48).any()


# ----------------------------------------------- full-width encoder specs ---

@pytest.fixture(scope='module')
def full_width():
    """second.yaml's scans (bench density) voxelized at the eval and the
    train cap: {train: coords}."""
    cfg = config.cfg_from_yaml_file(str(detect.SECOND_CFG))
    points, mask, _ = make_train_scans(cfg, 2, ring_keep=0.35)
    det = detect.build_detector(cfg, 'cpu')
    out = {}
    for train in (False, True):
        det.max_voxels = int(cfg.DATA_CONFIG['TRAIN' if train else 'TEST']
                             .MAX_NUMBER_OF_VOXELS)
        vox = det.voxelize(torch.as_tensor(points), torch.as_tensor(mask))
        out[train] = vox['coordinates']
    return out


def _books_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, book in want.items():
        other = got[key]
        pairs = (zip(book, other) if isinstance(book, tuple)
                 else [(book, other)])
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert torch.equal(a, b), key


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('cfg_path', [detect.SECOND_CFG, detect.PARTA2_CFG])
def test_device_books_equal_host_books_full_width(full_width, cfg_path,
                                                  train):
    cfg = config.cfg_from_yaml_file(str(cfg_path))
    model = detect.build_detector(cfg, 'cpu').model
    assert model.sparse_shape == (41, 1600, 1408)
    coords = full_width[train]
    want = model.upload_books(model.build_books(coords.numpy(), train),
                              coords.shape[1], train)
    got = model.device_books(coords, train)
    _books_equal(got, want)
    drops = [int(got[k][3].sum()) for k in got if isinstance(got[k], tuple)]
    assert drops == [int(want[k][3].sum()) for k in want
                     if isinstance(want[k], tuple)]
    assert int(got['spconv2'][2].sum()) > 40000


# -------------------------------------------------- models on the switch ---

def _flat(ret):
    """A model's output dict as (name, tensor) pairs, nested dicts flattened."""
    out = []
    for k, v in sorted(ret.items()):
        if isinstance(v, dict):
            out += [(k + '.' + a, b) for a, b in _flat(v)]
        elif torch.is_tensor(v):
            out.append((k, v))
    return out


@pytest.fixture(scope='module', params=['second', 'parta2'])
def model_run(request):
    """pcdet_tpu's eval forward with no books (its device builders) and the
    port's on the same variables, with host books and with
    PCDET_HOST_BOOKS=0."""
    parta2 = request.param == 'parta2'
    cfg = tiny_parta2_cfg(1) if parta2 else tiny_second_cfg(1)
    points, mask = _scans(cfg)
    dc = cfg.DATA_CONFIG
    vs, pr = tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE), tuple(dc.POINT_CLOUD_RANGE)
    cap = int(dc.TEST.MAX_NUMBER_OF_VOXELS)
    jmodel = (JaxPartA2Net if parta2 else JaxSECONDNet)(cfg, grid_size(vs, pr))
    vox = jax.vmap(lambda q, m: voxelize_jnp(
        q, m, vs, pr, int(dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL), cap))(
            jnp.asarray(points), jnp.asarray(mask))
    batch = {'voxels': vox['voxels'], 'num_points': vox['num_points_per_voxel'],
             'coordinates': vox['coordinates'],
             'voxel_mask': vox['voxel_mask']}
    template = jax.eval_shape(
        lambda: jmodel.init_variables(jax.random.PRNGKey(0), batch))
    variables = _random_variables(template, 0)
    ret, _ = jmodel.forward(variables, batch, train=False)     # no books
    sd = weights.state_dict_from_flax(
        variables, cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums'],
        cfg.MODEL.RCNN if parta2 else None)
    det = detect.build_detector(cfg, 'cpu', state_dict=sd)
    pts, msk = torch.as_tensor(points), torch.as_tensor(mask)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for switch in ('1', '0'):
            mp.setenv('PCDET_HOST_BOOKS', switch)
            with torch.inference_mode():
                vox_t = det.voxelize(pts, msk)
                books = det.books(vox_t)
                # with no books in the batch, forward builds them on the
                # device under =0
                port_ret = det.model.forward(
                    dict(vox_t, books=books) if switch == '1' else vox_t)
                runs[switch] = {'books': books, 'ret': port_ret,
                                'preds': det.detect(pts, msk)}
    return {'cfg': cfg, 'variables': variables, 'ret': ret, 'runs': runs,
            'parta2': parta2, 'sd': sd, 'points': points, 'mask': mask}


def test_detect_device_books_equal_host_books(model_run):
    host, dev = model_run['runs']['1'], model_run['runs']['0']
    _books_equal(dev['books'], host['books'])
    got, want = _flat(dev['ret']), _flat(host['ret'])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert torch.equal(a, b), k
    for k, v in host['preds'].items():
        assert torch.equal(dev['preds'][k], v), k
    assert (host['preds']['num'] > 0).all()


def test_device_book_forward_matches_jax_device_builds(model_run):
    ret, port = model_run['ret'], model_run['runs']['0']['ret']
    keys = ['spatial_features', 'box_preds', 'cls_preds', 'dir_cls_preds']
    if model_run['parta2']:
        keys += ['u_seg_preds', 'u_reg_preds', 'seg_features']
        for k in ('rcnn_cls', 'rcnn_reg', 'rois'):
            _close(port['rcnn'][k].numpy(), ret['rcnn'][k], TOL)
        np.testing.assert_array_equal(port['rcnn']['roi_valid'].numpy(),
                                      np.asarray(ret['rcnn']['roi_valid']))
    for k in keys:
        _close(port[k].numpy(), ret[k], TOL)
    for name in ('conv2', 'conv3', 'conv4', 'conv_out'):
        np.testing.assert_array_equal(port['overflow'][name].numpy(),
                                      np.asarray(ret['overflow'][name]))


def _step(cfg, sd, points, mask, gt, switch, monkeypatch):
    monkeypatch.setenv('PCDET_HOST_BOOKS', switch)
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=2)
    trainer.model.module.load_state_dict(sd)
    batch = trainer.make_batch(torch.as_tensor(points), torch.as_tensor(mask),
                               gt)
    tb = trainer.step(batch)
    return batch, tb, trainer.model.module.state_dict()


def test_train_step_device_books_equal_host_books(model_run, monkeypatch):
    cfg = copy.deepcopy(model_run['cfg'])
    points, mask, gt = make_train_scans(cfg, 2)
    runs = [_step(cfg, model_run['sd'], points, mask, gt, s, monkeypatch)
            for s in ('1', '0')]
    (hb, htb, hsd), (db, dtb, dsd) = runs
    _books_equal(db['books'], hb['books'])
    assert sorted(dtb) == sorted(htb) and 'overflow/conv2' in htb
    for k, v in htb.items():
        assert torch.equal(dtb[k], v), k
    assert np.isfinite(float(htb['loss']))
    for k, v in hsd.items():
        assert torch.equal(dsd[k], v), k


# --------------------------------------------------------- the loader ---

def test_loader_path_builds_device_books(monkeypatch):
    cfg = tiny_second_cfg(1)
    det = detect.build_detector(cfg, 'cpu')
    points, mask = _scans(cfg, 3)
    vox = det.voxelize(torch.as_tensor(points), torch.as_tensor(mask))
    batch = {'voxels': vox['voxels'].numpy(),
             'num_points': vox['num_points_per_voxel'].numpy(),
             'coordinates': vox['coordinates'].numpy(),
             'voxel_mask': vox['voxel_mask'].numpy(),
             'voxel_overflow': vox['voxel_overflow'].numpy()}
    transform = host_books.make_batch_transform(det.model, training=False)
    assert transform is not None
    with_books = transform(dict(batch))
    want = host_books.upload_loader_batch(with_books, 'cpu', det.model,
                                          train=False)
    with pytest.raises(ValueError, match='hb_'):
        host_books.upload_loader_batch(batch, 'cpu', det.model, train=False)
    monkeypatch.setenv('PCDET_HOST_BOOKS', '0')
    assert host_books.make_batch_transform(det.model, training=False) is None
    got = host_books.upload_loader_batch(batch, 'cpu', det.model, train=False)
    _books_equal(got['books'], want['books'])
    for k in ('voxels', 'coordinates', 'voxel_mask', 'num_points_per_voxel'):
        assert torch.equal(got[k], want[k]), k
    for k, v in det.detect_batch(want).items():
        assert torch.equal(det.detect_batch(got)[k], v), k


def _fork_cfg():
    cfg = tiny_second_cfg(3)
    cfg.USE_PSEUDOLIDAR = True
    cfg.MODE = '3dobjdet'
    return config.cfg_preprocess(cfg)


def test_revoxelizing_step_voxelizes_once_with_device_books(monkeypatch):
    cfg = _fork_cfg()
    assert cfg.TORCH_VOXEL_GENERATOR
    points, mask, gt = make_train_scans(cfg, 2)
    calls = []
    voxelize = experiments.voxelize_torch

    def counted(*args, **kw):
        out = voxelize(*args, **kw)
        calls.append(out['coordinates'])
        return out

    monkeypatch.setattr(experiments, 'voxelize_torch', counted)
    runs = {}
    for switch in ('1', '0'):
        monkeypatch.setenv('PCDET_HOST_BOOKS', switch)
        calls.clear()
        trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=2)
        seen = []
        backbone = trainer.model.module.rpn_net
        forward = backbone.forward

        def spy(level, books, *args, forward=forward, seen=seen):
            seen.append(books)
            return forward(level, books, *args)

        monkeypatch.setattr(backbone, 'forward', spy)
        batch = trainer.make_batch(torch.as_tensor(points),
                                   torch.as_tensor(mask), gt)
        assert ('books' in batch) == (switch == '1')
        loss, tb, grads = train_state.loss_and_grads(
            trainer.model, list(trainer.state.params), batch)
        runs[switch] = (len(calls), calls[-1], seen[-1], loss, tb, grads)
    (n_host, c_host, b_host, l_host, tb_host, g_host) = runs['1']
    (n_dev, c_dev, b_dev, l_dev, tb_dev, g_dev) = runs['0']
    assert (n_host, n_dev) == (2, 1)
    assert torch.equal(c_dev, c_host)
    _books_equal(b_dev, b_host)
    assert torch.equal(l_dev, l_host)
    for k, v in tb_host.items():
        assert torch.equal(tb_dev[k], v), k
    for a, b in zip(g_dev, g_host):
        assert torch.equal(a, b)


# ---------------------------------------------------- the inverse conv ---

@pytest.fixture(scope='module')
def unet_levels():
    """A tiny Part-A² scan's level and its device-built eval books."""
    cfg = tiny_parta2_cfg(1)
    det = detect.build_detector(cfg, 'cpu')
    points, mask = _scans(cfg)
    vox = det.voxelize(torch.as_tensor(points), torch.as_tensor(mask))
    books = det.model.device_books(vox['coordinates'], train=False)
    rng = np.random.RandomState(2)
    m = vox['voxel_mask']
    f = torch.as_tensor(rng.randn(*m.shape, 16).astype(np.float32)) * m[..., None]
    level = sparse.from_voxelizer(f, vox['coordinates'], m,
                                  det.model.sparse_shape)
    levels = [level]
    for key in ('spconv2', 'spconv3', 'spconv4'):
        ids, coords, mask_, _, _ = books[key]
        op = [o for o in det.model.host_book_spec(3000) if o[1] == key][0]
        levels.append(sparse.SparseLevel(
            None, ids, coords, mask_, sparse.conv_out_shape(
                levels[-1].shape, *op[2:5])))
    return levels, books, det.model


@pytest.mark.parametrize('i,key,padding', [(0, 'spconv2', (1, 1, 1)),
                                           (1, 'spconv3', (1, 1, 1)),
                                           (2, 'spconv4', (0, 1, 1))])
def test_inverse_conv_without_book_equals_key_reuse(unet_levels, i, key,
                                                    padding):
    levels, books, _ = unet_levels
    fine, coarse = levels[i], levels[i + 1]
    rng = np.random.RandomState(i)
    g = torch.as_tensor(rng.randn(*coarse.mask.shape, 16).astype(np.float32))
    g = g * coarse.mask[..., None]
    w = torch.as_tensor(rng.uniform(-0.2, 0.2, (27, 16, 16)).astype(
        np.float32))
    fine = fine._replace(features=torch.zeros(*fine.mask.shape, 1))
    assert torch.equal(sparse.inverse_rules_geometric(coarse, fine, 3, 2,
                                                      padding),
                       sparse.inverse_rules(books[key][4], fine.mask))
    outs = []
    for book in (books[key], None, books['spconv2' if i else 'spconv3']):
        feats = g.clone().requires_grad_(True)
        weight = w.clone().requires_grad_(True)
        out = sparse.inverse_conv3d(coarse._replace(features=feats), fine,
                                    weight, book, 3, 2, padding,
                                    loads=sparse.ROWS)
        df, dw = torch.autograd.grad((out.features ** 2).sum(),
                                     (feats, weight))
        outs.append((out.features, df, dw))
    for other in outs[1:]:
        for a, b in zip(other, outs[0]):
            assert torch.equal(a, b)
    assert outs[0][0].abs().max() > 0 and outs[0][1].abs().max() > 0


# ---------------------------------------- max-pool, bottleneck, in-box ---

@pytest.mark.parametrize('kernel,stride,padding,cap', [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), None),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1), 16),
    ((2, 2, 2), (2, 2, 2), (0, 0, 0), None)])
def test_sparse_maxpool_matches_pcdet_tpu(kernel, stride, padding, cap):
    port, jax_levels = _levels((7, 8))
    rng = np.random.RandomState(5)
    f = rng.randn(2, 80, 6).astype(np.float32) * port.mask.numpy()[..., None]
    got = sparse.sparse_maxpool3d(port._replace(features=torch.as_tensor(f)),
                                  kernel, stride, padding, cap)
    jl = [lv._replace(features=jnp.asarray(f[i]))
          for i, lv in enumerate(jax_levels)]
    want = jax_sparse.sparse_maxpool3d_batched(
        jax_sparse.SparseLevel(jnp.stack([lv.features for lv in jl]),
                               jnp.stack([lv.ids for lv in jl]),
                               jnp.stack([lv.coords for lv in jl]),
                               jnp.stack([lv.mask for lv in jl]), SHAPE),
        kernel, stride, padding, cap)
    assert got.shape == want.shape
    for a, b in ((got.features, want.features), (got.ids, want.ids),
                 (got.coords, want.coords), (got.mask, want.mask),
                 (got.overflow, want.overflow)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.features.abs().max() > 0


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('inplanes,planes', [(16, 4), (16, 16)])
def test_sparse_bottleneck_matches_pcdet_tpu(inplanes, planes, train):
    """Eval (running statistics) and train (masked batch statistics): 1e-5
    of max |out|, the convs' sums in another order; projection where
    inplanes != 4 * planes."""
    port, jax_levels = _levels((3, 4), v=80, shape=(6, 9, 10))
    rng = np.random.RandomState(1)
    f = (rng.randn(2, 80, inplanes).astype(np.float32)
         * port.mask.numpy()[..., None])
    level = jax_sparse.SparseLevel(
        jnp.asarray(f), jnp.stack([lv.ids for lv in jax_levels]),
        jnp.stack([lv.coords for lv in jax_levels]),
        jnp.stack([lv.mask for lv in jax_levels]), (6, 9, 10))
    mod = jax_bb.SparseBottleneck(planes=planes)
    template = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), level,
                                               False))
    variables = _random_variables(template, 2)
    want, upd = mod.apply(variables, level, train, mutable=['batch_stats'])
    net = SparseBottleneck(inplanes, planes)
    net.load_state_dict(weights.state_dict_from_flax(variables, ()))
    assert (net.downsample is None) == (inplanes == 4 * planes)
    net.train(train)
    got = net(port._replace(features=torch.as_tensor(f)))
    _close(got.features.detach().numpy(), want.features, 1e-5)
    if train:
        stats = weights.state_dict_from_flax(
            {'params': variables['params'], 'batch_stats': upd['batch_stats']},
            ())
        for k, v in net.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                           rtol=1e-5, atol=1e-6)


def test_points_in_boxes_match_pcdet_tpu():
    """The in-box masks equal except at points within 1e-5 of a face, where
    the two packages' sin / cos may round apart."""
    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.uniform(-8, 8, (12, 2)),
                            rng.uniform(-2, 0, (12, 1)),
                            rng.uniform(1, 5, (12, 3)),
                            rng.uniform(-np.pi, np.pi, (12, 1))], 1)
    pts = np.concatenate([rng.uniform(-10, 10, (3000, 2)),
                          rng.uniform(-3, 4, (3000, 1)),
                          rng.rand(3000, 1)], 1).astype(np.float32)
    boxes = boxes.astype(np.float32)
    pmask = rng.rand(3000) > 0.1
    got = torch_common.points_in_boxes(torch.as_tensor(pts),
                                       torch.as_tensor(boxes)).numpy()
    want = np.asarray(jnp_common.points_in_boxes(jnp.asarray(pts),
                                                 jnp.asarray(boxes)))
    got_b = roiaware_pool.points_in_boxes_batch(
        torch.as_tensor(pts), torch.as_tensor(boxes),
        torch.as_tensor(pmask)).numpy()
    want_b = np.asarray(jax_pool.points_in_boxes_batch(
        jnp.asarray(pts), jnp.asarray(boxes), jnp.asarray(pmask)))
    # the distance of each point to the nearest face, in f64
    b = boxes.astype(np.float64)
    shift = pts[None, :, :3].astype(np.float64) - b[:, None, :3]
    c, s = np.cos(-b[:, 6])[:, None], np.sin(-b[:, 6])[:, None]
    lx = shift[..., 0] * c + shift[..., 1] * s
    ly = -shift[..., 0] * s + shift[..., 1] * c
    margin = np.minimum.reduce([
        np.abs(np.abs(lx) - b[:, 3:4] / 2), np.abs(np.abs(ly) - b[:, 4:5] / 2),
        np.abs(shift[..., 2]), np.abs(shift[..., 2] - b[:, 5:6])])
    near = margin < 1e-5
    assert got.dtype == bool and got.shape == (12, 3000)
    np.testing.assert_array_equal(got[~near], want[~near])
    np.testing.assert_array_equal(got_b[~near], want_b[~near])
    assert got.sum() > 50 and not got_b[:, ~pmask].any()
