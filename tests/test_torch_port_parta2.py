"""pcdet_tpu_torch Part-A² eval vs pcdet_tpu (CPU, tiny_parta2_cfg, B=2).

One set of random flax variables (torch-like uniform kernels, random BN
affine and statistics, random FC biases, conv_cls's bias zeroed so that
proposals exist) runs through `pcdet_tpu.models.parta2.PartA2Net`
(voxelize_jnp, host books, `forward`, `predict`) once per file, and
through the port's `detect.build_detector(cfg).detect`, which voxelizes,
builds and uploads the books itself:

- the UNet's BEV, seg and part logits and seg features to 1e-4 of their
  largest value (f32); in bf16 (UNetV2 alone, on random features) within
  3e-2, and not the f32 result;
- the inverse conv alone against `pcdet_tpu.ops.sparse.inverse_conv3d` on
  the same books, 1e-5 of max |out|; it refuses a geometry that did not
  make its input, and takes its rules from the geometry for another conv's
  book or none;
- `roiaware_pool3d_multi_batched` on a scene with points on the cells'
  boundaries: max bitwise, avg to 1e-6 of max, the overflow count equal;
  the cells whose points' (cell, in-box) differ between the two
  (`flipped`) are named, and only there may the grids differ;
- SpConvRCNN (14³) and FCRCNN (12³) to 1e-4 on random sparse grids;
- the proposal layer on injected logits (1 and 3 classes, rotated and
  axis-aligned): the same RoIs, labels, scores and valid mask;
- `post_process_batch` with the labels override and under
  MULTI_CLASSES_NMS, 1 and 3 classes: the same selections;
- the whole predict: count, valid and labels equal, boxes and scores to
  1e-4;
- the loader path (`hb_*` books in the batch) gives what detect gives;
- the port's state_dict converts back to the flax variables through
  `pcdet_tpu.train.torch_import.convert_state_dict`, with no unused key.
- in train mode (`train.trainer.build_trainer`) the forward returns the
  RCNN's sampled targets and `loss` pcdet_tpu's tb keys; under
  MODEL.RPN.PARAMS_FIXED a step moves none of stage 1's parameters.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_config import tiny_parta2_cfg

from pcdet_tpu.datasets.synthetic import make_scene
from pcdet_tpu.models import backbones3d as jax_bb
from pcdet_tpu.models import detector3d as jax_det
from pcdet_tpu.models import roi_heads as jax_roi
from pcdet_tpu.models.parta2 import PartA2Net as JaxPartA2Net
from pcdet_tpu.ops import host_books as jax_books
from pcdet_tpu.ops import roiaware_pool as jax_pool
from pcdet_tpu.ops import sparse as jax_sparse
from pcdet_tpu.ops.voxelizer import voxelize_jnp
from pcdet_tpu.train import torch_import
from pcdet_tpu.utils.box_coder import ResidualCoder as JaxCoder
from pcdet_tpu_torch import detect, weights
from pcdet_tpu_torch.models import detector3d, parta2, roi_heads
from pcdet_tpu_torch.models.backbones3d import UNetV2
from pcdet_tpu_torch.ops import roiaware_pool, sparse
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans
from pcdet_tpu_torch.utils.box_coder import ResidualCoder

torch.set_num_threads(1)

TOL = 1e-4
BF16_TOL = 3e-2
HEADS = ('box_preds', 'cls_preds', 'dir_cls_preds')
UNET = ('u_seg_preds', 'u_reg_preds', 'seg_features', 'spatial_features')


def _scans(cfg, seed=0):
    rng = np.random.RandomState(seed)
    p = int(cfg.DATA_CONFIG.MAX_POINTS)
    points = np.zeros((2, p, 4), np.float32)
    mask = np.zeros((2, p), bool)
    for i in range(2):
        pts, _, _ = make_scene(rng, ['Car'], num_objects=4, x_range=(3, 30),
                               y_range=(-14, 14))
        n = min(len(pts), p)
        points[i, :n], mask[i, :n] = pts[:n], True
    return points, mask


def _random_variables(template, seed):
    """Flax variables of the template's shapes: torch-like uniform kernels,
    random BN affine and statistics and biases, conv_cls's bias zero."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        names = [getattr(p, 'key', '') for p in path]
        shape = leaf.shape
        if names[-1].startswith('kernel'):
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if names[-1] == 'bias' and 'conv_cls' in names:
            return np.zeros(shape, np.float32)
        if names[-1] in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _port_detector(cfg, variables, **kw):
    det = detect.build_detector(cfg, 'cpu', seed=0, **kw)
    det.model.module.load_state_dict(weights.state_dict_from_flax(
        variables, cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums'], cfg.MODEL.RCNN))
    return det


@pytest.fixture(scope='module')
def whole():
    """The JAX reference's forward and predict, once, and the port's, on the
    same variables and scans (num_class 1, f32)."""
    cfg = tiny_parta2_cfg(num_class=1)
    points, mask = _scans(cfg)
    dc = cfg.DATA_CONFIG
    vs = tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE)
    pr = tuple(dc.POINT_CLOUD_RANGE)
    cap = int(dc.TEST.MAX_NUMBER_OF_VOXELS)
    jmodel = JaxPartA2Net(cfg, grid_size(vs, pr))
    vox = jax.vmap(lambda q, m: voxelize_jnp(
        q, m, vs, pr, int(dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL), cap))(
            jnp.asarray(points), jnp.asarray(mask))
    batch = {'voxels': vox['voxels'], 'num_points': vox['num_points_per_voxel'],
             'coordinates': vox['coordinates'],
             'voxel_mask': vox['voxel_mask']}
    template = jax.eval_shape(
        lambda: jmodel.init_variables(jax.random.PRNGKey(0), batch))
    variables = _random_variables(template, 0)
    flat = jax_books.build_books_batch(
        np.asarray(vox['coordinates']), np.asarray(vox['voxel_mask']),
        jmodel.sparse_shape, jmodel.host_book_spec(cap, False))
    batch.update({k: jnp.asarray(v) for k, v in flat.items()})
    ret, _ = jmodel.forward(variables, batch, train=False)
    want = jmodel.predict(ret)

    det = _port_detector(cfg, variables)
    pts, msk = torch.as_tensor(points), torch.as_tensor(mask)
    with torch.inference_mode():
        vox_t = det.voxelize(pts, msk)
        vox_t['books'] = det.books(vox_t)
        port_ret = det.model.forward(vox_t)
    got = det.detect(pts, msk)
    return {'cfg': cfg, 'jax_model': jmodel, 'variables': variables,
            'det': det, 'ret': ret, 'want': want, 'port_ret': port_ret,
            'got': got, 'flat': flat, 'batch': batch, 'points': points,
            'mask': mask}


def test_stage1_matches_jax_f32(whole):
    ret, port = whole['ret'], whole['port_ret']
    assert port['spatial_features'].shape == (2, 16, 16, 128)
    assert port['u_seg_preds'].shape == (2, 3000, 1)
    for k in UNET + HEADS:
        _close(port[k].numpy(), ret[k], TOL)
    for name, drops in port['overflow'].items():
        np.testing.assert_array_equal(np.asarray(drops),
                                      np.asarray(ret['overflow'][name]))


def test_stage2_matches_jax_f32(whole):
    """RoIs (through the proposal layer), the pool's overflow, the RCNN's
    outputs."""
    ret, port = whole['ret']['rcnn'], whole['port_ret']['rcnn']
    np.testing.assert_array_equal(port['roi_valid'].numpy(),
                                  np.asarray(ret['roi_valid']))
    assert port['roi_valid'].any()
    np.testing.assert_array_equal(port['roi_labels'].numpy(),
                                  np.asarray(ret['roi_labels']))
    _close(port['rois'].numpy(), ret['rois'], TOL)
    _close(port['roi_raw_scores'].numpy(), ret['roi_raw_scores'], TOL)
    for k in ('rcnn_cls', 'rcnn_reg'):
        _close(port[k].numpy(), ret[k], TOL)
    assert int(whole['port_ret']['overflow']['roi_pts']) == int(
        whole['ret']['overflow']['roi_pts'])


def test_predict_matches_jax(whole):
    want = {k: np.asarray(v) for k, v in whole['want'].items()}
    got = {k: v.numpy() for k, v in whole['got'].items()}
    assert (want['num'] > 0).all()
    np.testing.assert_array_equal(got['num'], want['num'])
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    np.testing.assert_allclose(got['boxes'], want['boxes'], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got['scores'], want['scores'], rtol=TOL,
                               atol=TOL)


def test_loader_books_path_matches_detect(whole):
    det = whole['det']
    batch = det.voxelize(torch.as_tensor(whole['points']),
                         torch.as_tensor(whole['mask']))
    batch.update(whole['flat'])                   # the loader's hb_* arrays
    got = det.detect_batch(batch)
    for k, v in whole['got'].items():
        assert torch.equal(got[k], v), k


def test_state_dict_round_trip(whole):
    """The port's state_dict back through `torch_import` gives the flax
    variables; an FC before BN gives its bias to the BN's running mean,
    so the variables are taken with those biases zero, as an init has
    them."""
    variables = copy.deepcopy(jax.device_get(whole['variables']))
    rp = variables['params']['rcnn']
    fc = [k for k in rp if k.startswith(('shared_fc_', 'cls_fc_', 'reg_fc_'))]
    assert fc
    for k in fc:
        rp[k]['bias'] = np.zeros_like(rp[k]['bias'])
    det = _port_detector(whole['cfg'], variables)
    sd = {k: v.numpy() for k, v in det.model.module.state_dict().items()}
    back, unused = torch_import.convert_state_dict(sd, whole['jax_model'])
    assert unused == []
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)
    # with the biases it had, each moved into its BN's running mean
    sd = whole['det'].model.module.state_dict()
    v = whole['variables']
    for name, key in (('shared_fc_0', 'shared_fc_layer.0'),
                      ('cls_fc_0', 'cls_layer.0')):
        mean = np.asarray(v['batch_stats']['rcnn'][name]['TorchBatchNorm_0'][
            'mean'])
        bias = np.asarray(v['params']['rcnn'][name]['bias'])
        assert np.abs(bias).max() > 0
        np.testing.assert_array_equal(
            sd['rcnn_net.%s.bn.bn.running_mean' % key].numpy(), mean - bias)


def _train_setup(whole, params_fixed=False):
    cfg = copy.deepcopy(whole['cfg'])
    cfg.MODEL.RPN.PARAMS_FIXED = params_fixed
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=2)
    trainer.model.module.load_state_dict(weights.state_dict_from_flax(
        whole['variables'], cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums'],
        cfg.MODEL.RCNN))
    points, mask, gt = make_train_scans(cfg, 2)
    return trainer, trainer.make_batch(torch.as_tensor(points),
                                       torch.as_tensor(mask), gt)


def test_forward_in_train_mode_returns_targets(whole):
    """A train-mode forward samples ROI_PER_IMAGE RoIs a sample from TRAIN's
    proposals and returns the RCNN's targets beside its outputs; `loss`
    gives pcdet_tpu's tb keys."""
    trainer, batch = _train_setup(whole)
    model = trainer.model
    with torch.no_grad():
        ret = model.forward(batch)
        loss, tb = model.loss(ret, batch)
    rcnn = ret['rcnn']
    r = int(whole['cfg'].MODEL.RCNN.TARGET_CONFIG.ROI_PER_IMAGE)
    for k in ('rois', 'gt_of_rois', 'gt_of_rois_src'):
        assert rcnn[k].shape == (2, r, 7 if k == 'rois' else 8), k
    for k in ('gt_iou', 'rcnn_cls_labels', 'reg_valid_mask',
              'roi_raw_scores', 'roi_labels', 'roi_valid', 'rcnn_cls'):
        assert rcnn[k].shape == (2, r), k
    assert rcnn['rcnn_reg'].shape == (2, r, 7)
    assert sorted(model.last_sampler) == ['fg_count', 'hard_num', 'n_easy',
                                          'n_fg', 'n_hard', 'picks']
    assert 'roi_pts' in ret['overflow']
    assert {'rpn_loss_u_cls', 'rpn_u_loss_reg', 'rpn_loss_unet',
            'rpn_pos_num', 'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir',
            'rpn_loss', 'rcnn_loss_cls', 'rcnn_loss_reg', 'rcnn_loss_corner',
            'rcnn_loss', 'loss', 'overflow/roi_pts'} <= set(tb)
    assert torch.isfinite(loss) and float(tb['loss']) == float(loss)


def test_params_fixed_step_leaves_stage1_unchanged(whole):
    """MODEL.RPN.PARAMS_FIXED: the optimizer holds the RCNN's parameters
    only; a step computes stage 1's losses (as without the flag) and
    changes none of its parameters (its BN statistics still move)."""
    free, batch = _train_setup(whole)
    with torch.no_grad():
        want = free.model.loss(free.model.forward(batch), batch)[1]
    trainer, _ = _train_setup(whole, params_fixed=True)
    names = {n for n, _ in trainer.model.module.named_parameters()
             if n.startswith('rcnn_net.')}
    assert set(trainer.state.optimizer.names) == names
    before = {k: v.clone() for k, v in
              trainer.model.module.state_dict().items()}
    tb = trainer.step(batch)
    for k in ('rpn_loss', 'rpn_loss_unet'):
        np.testing.assert_allclose(float(tb[k]), float(want[k]), rtol=1e-6)
    after = trainer.model.module.state_dict()
    for k, v in before.items():
        moved = not torch.equal(after[k], v)
        if k.startswith(parta2.STAGE1):
            assert moved == k.endswith(('running_mean', 'running_var',
                                        'num_batches_tracked')), k
    assert not torch.equal(after['rcnn_net.cls_layer.2.conv.weight'],
                           before['rcnn_net.cls_layer.2.conv.weight'])


# ------------------------------------------------------------- the UNet ---

def _unet_pair(whole, compute_dtype):
    """JAX UNetV2 and the port's on random input features over the scan's
    voxels, at `compute_dtype_test`."""
    cfg = whole['cfg']
    jm = whole['jax_model']
    v = whole['variables']
    batch = whole['batch']
    rng = np.random.RandomState(4)
    feats = rng.randn(*batch['voxels'].shape[:2], 4).astype(np.float32)
    feats *= np.asarray(batch['voxel_mask'])[..., None]
    level = jax_sparse.from_voxelizer(jnp.asarray(feats),
                                      batch['coordinates'],
                                      batch['voxel_mask'], jm.sparse_shape)
    unet = jax_bb.UNetV2(sparse_shape=jm.sparse_shape, last_pad=(1, 0, 0),
                         compute_dtype_test=compute_dtype)
    bev, out = unet.apply(
        {'params': v['params']['stage1']['unet'],
         'batch_stats': v['batch_stats']['stage1']['unet']}, level, False,
        books=jax_books.unpack_books(batch))
    out['spatial_features'] = bev

    port = UNetV2(4, (1, 0, 0))
    sd = weights.state_dict_from_flax(
        v, cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums'], cfg.MODEL.RCNN)
    port.load_state_dict({k[len('rpn_net.'):]: t for k, t in sd.items()
                          if k.startswith('rpn_net.')})
    port.eval()
    books = whole['det'].model.upload_books(
        whole['flat'], batch['voxels'].shape[1], train=False)
    coords = torch.as_tensor(np.asarray(batch['coordinates']))
    vmask = torch.as_tensor(np.asarray(batch['voxel_mask']))
    plevel = sparse.from_voxelizer(torch.as_tensor(feats), coords, vmask,
                                   jm.sparse_shape)
    with torch.inference_mode():
        pbev, _, pout = port(plevel, books, torch.bfloat16
                             if compute_dtype == 'bfloat16' else None)
    pout['spatial_features'] = pbev
    return out, pout, port


def test_unet_bf16_matches_jax(whole):
    want32, got32, _ = _unet_pair(whole, '')
    want, got, port = _unet_pair(whole, 'bfloat16')
    for k in UNET:
        _close(got32[k].numpy(), want32[k], TOL)
        _close(got[k].float().numpy(), want[k], BF16_TOL)
        # the bf16 path really ran: it is not the f32 result
        assert not np.allclose(np.asarray(want[k]), np.asarray(want32[k]),
                               rtol=0, atol=1e-6)
    assert port.xwin_clamped == {}


@pytest.mark.parametrize('loads', [sparse.Loads('xwin', 'rows'),
                                   sparse.Loads('seg', 'rows')],
                         ids=['xwin', 'seg'])
def test_unet_window_loads_match_rows(whole, loads):
    """The 27 kw=3 convs on E / E′'s plain versions give the rows loads'
    outputs; no selector build dropped a tap (the transposed books'
    included)."""
    det = _port_detector(whole['cfg'], whole['variables'], loads=loads)
    pts, msk = (torch.as_tensor(whole['points']),
                torch.as_tensor(whole['mask']))
    with torch.inference_mode():
        vox = det.voxelize(pts, msk)
        vox['books'] = det.books(vox)
        ret = det.model.forward(vox)
    clamped = det.model.module.rpn_net.xwin_clamped
    assert {'spconv2_inv', 'spconv3_inv', 'spconv4_inv'} <= set(clamped)
    assert all(int(v) == 0 for v in clamped.values())
    for k in UNET:
        _close(ret[k].numpy(), whole['port_ret'][k].numpy(), 1e-5)


# ---------------------------------------------------------- inverse conv ---

def _coarse_level(whole, cin, seed):
    """The input level with random features and spconv2's coarse level, in
    JAX (carrying its forward book) and in the port."""
    batch = whole['batch']
    pbooks = whole['det'].model.upload_books(
        whole['flat'], batch['voxels'].shape[1], train=False)
    shape = whole['jax_model'].sparse_shape
    rng = np.random.RandomState(seed)
    mask = np.asarray(batch['voxel_mask'])
    f = rng.randn(*mask.shape, cin).astype(np.float32) * mask[..., None]
    fine_j = jax_sparse.from_voxelizer(jnp.asarray(f), batch['coordinates'],
                                       batch['voxel_mask'], shape)
    fine_p = sparse.from_voxelizer(
        torch.as_tensor(f), torch.as_tensor(np.asarray(batch['coordinates'])),
        torch.as_tensor(mask), shape)
    w = rng.uniform(-0.2, 0.2, (27, cin, cin)).astype(np.float32)
    coarse_j = jax_sparse.sparse_conv3d_batched(
        fine_j, jnp.asarray(w), 3, 2, 1, indice_key='spconv2',
        book=jax_books.unpack_books(batch)['spconv2'])
    coarse_p = sparse.sparse_conv3d(fine_p, torch.as_tensor(w),
                                    pbooks['spconv2'], 3, 2, 1,
                                    loads=sparse.ROWS)
    return fine_j, fine_p, coarse_j, coarse_p, pbooks


def test_inverse_conv_matches_jax(whole):
    """inv_conv2's geometry (the inverse of spconv2, 16 -> 16 channels)
    on random coarse features: 1e-5 of max |out|, zero off the target's
    live sites; under window loads the same sums."""
    fine_j, fine_p, coarse_j, coarse_p, books = _coarse_level(whole, 16, 7)
    rng = np.random.RandomState(8)
    g = (rng.randn(*coarse_p.features.shape).astype(np.float32)
         * coarse_p.mask.numpy()[..., None])
    w = rng.uniform(-0.2, 0.2, (27, 16, 16)).astype(np.float32)
    want = jax_sparse.inverse_conv3d_batched(
        coarse_j._replace(features=jnp.asarray(g)), fine_j, jnp.asarray(w),
        3, 2, 1, indice_key='spconv2')
    cp = coarse_p._replace(features=torch.as_tensor(g))
    got = sparse.inverse_conv3d(cp, fine_p, torch.as_tensor(w),
                                books['spconv2'], 3, 2, 1, loads=sparse.ROWS)
    assert torch.equal(got.ids, fine_p.ids)
    _close(got.features.numpy(), want.features, 1e-5)
    assert not got.features[~fine_p.mask].any()
    for fwd in ('xwin', 'seg'):
        win = sparse.inverse_conv3d(cp, fine_p, torch.as_tensor(w),
                                    books['spconv2'], 3, 2, 1,
                                    loads=sparse.Loads(fwd, 'rows'))
        _close(win.features.numpy(), got.features.numpy(), 1e-6)


def test_inverse_conv_refuses_other_books(whole):
    """A geometry that does not give the input level's shape raises; another
    conv's book is not used: the rules come from the geometry, as
    pcdet_tpu falls back to `_rules_inverse`, and give the right book's
    output."""
    _, fine_p, _, coarse_p, books = _coarse_level(whole, 16, 9)
    w = torch.as_tensor(np.random.RandomState(3).uniform(
        -0.2, 0.2, (27, 16, 16)).astype(np.float32))
    with pytest.raises(ValueError):                 # another geometry
        sparse.inverse_conv3d(coarse_p, fine_p, w, books['spconv2'], 3, 2,
                              (0, 1, 1), loads=sparse.ROWS)
    want = sparse.inverse_conv3d(coarse_p, fine_p, w, books['spconv2'], 3, 2,
                                 1, loads=sparse.ROWS)
    for other in (books['spconv3'], None):          # another conv's, none
        got = sparse.inverse_conv3d(coarse_p, fine_p, w, other, 3, 2, 1,
                                    loads=sparse.ROWS)
        assert torch.equal(got.features, want.features)
    assert want.features.abs().max() > 0


# ---------------------------------------------------------- RoI pooling ---

def _boundary_scene(seed=0, b=2, n=6, o=6):
    """RoIs (half axis-aligned, half rotated) and points of which about half
    sit exactly on their RoI's cell boundaries in its frame (x, y, z), the
    rest uniform in and around the boxes, and random padding."""
    rng = np.random.RandomState(seed)
    rois = np.zeros((b, n, 7), np.float32)
    rois[..., 0:2] = rng.uniform(-8, 8, (b, n, 2))
    rois[..., 2] = rng.uniform(-2, 0, (b, n))
    rois[..., 3:6] = np.round(rng.uniform(1.5, 4.5, (b, n, 3)) * 4) / 4
    rois[:, n // 2:, 6] = rng.uniform(-np.pi, np.pi, (b, n - n // 2))
    per = 40
    pts = []
    for i in range(b):
        rows = []
        for r in range(n):
            x, y, z, w, l, h, ry = rois[i, r]
            grid = np.stack([rng.randint(0, o + 1, per) * w / o - w / 2,
                             rng.randint(0, o + 1, per) * l / o - l / 2,
                             rng.randint(0, o + 1, per) * h / o], -1)
            loose = rng.uniform(-0.6, 0.6, (per, 3)) * [w, l, h] + [0, 0, h / 2]
            local = np.concatenate([grid, loose]).astype(np.float32)
            c, s = np.cos(ry), np.sin(ry)
            world = np.stack([local[:, 0] * c - local[:, 1] * s + x,
                              local[:, 0] * s + local[:, 1] * c + y,
                              local[:, 2] + z], -1)
            rows.append(world)
        pts.append(np.concatenate(rows))
    pts = np.stack(pts).astype(np.float32)
    mask = rng.rand(*pts.shape[:2]) > 0.05
    feats_max = rng.randn(*pts.shape[:2], 5).astype(np.float32)
    feats_avg = rng.rand(*pts.shape[:2], 4).astype(np.float32)
    return rois, pts, mask, feats_max, feats_avg


@pytest.mark.parametrize('cap', [128, 20])
def test_roiaware_pool_matches_jax(cap):
    o = 6
    rois, pts, mask, fmax, favg = _boundary_scene(o=o)
    (j_avg, j_max), j_ovf = jax_pool.roiaware_pool3d_multi_batched(
        jnp.asarray(rois), jnp.asarray(pts),
        [(jnp.asarray(favg), 'avg'), (jnp.asarray(fmax), 'max')],
        jnp.asarray(mask), out_size=o, max_pts_per_roi=cap,
        return_overflow=True)
    (p_avg, p_max), p_ovf = roiaware_pool.roiaware_pool3d_multi_batched(
        torch.as_tensor(rois), torch.as_tensor(pts),
        [(torch.as_tensor(favg), 'avg'), (torch.as_tensor(fmax), 'max')],
        torch.as_tensor(mask), out_size=o, max_pts_per_roi=cap,
        return_overflow=True)
    assert int(p_ovf) == int(j_ovf)
    assert (int(p_ovf) > 0) == (cap == 20)

    # the points whose cell or in-box test differs between the two
    j_cell, j_in = jax_pool._roi_local_cells(
        jnp.asarray(rois), jnp.asarray(pts)[:, None], o)
    p_cell, p_in = roiaware_pool.roi_local_cells(
        torch.as_tensor(rois), torch.as_tensor(pts)[:, None], o)
    j_cell, j_in = np.asarray(j_cell), np.asarray(j_in)
    p_cell, p_in = p_cell.numpy(), p_in.numpy()
    diff = ((j_in != p_in) | (j_in & (j_cell != p_cell))) & mask[:, None]
    flipped = sorted({(bi, r, int(c)) for bi, r, q in zip(*np.nonzero(diff))
                      for c in (j_cell[bi, r, q], p_cell[bi, r, q])})
    if flipped:
        print('cells whose points flip between JAX and the port (b, roi, '
              'cell):', flipped)
    # boundary points lie exactly on edges: the grid really tests them
    on_edge = (p_in & mask[:, None]).sum()
    assert on_edge > 100
    assert int(p_in.sum(-1).max()) <= 128
    keep = np.ones(p_max.shape[:2] + (o ** 3,), bool)
    for bi, r, c in flipped:
        keep[bi, r, c] = False
    keep = keep.reshape(p_max.shape[:5])
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(p_max.numpy()[keep], np.asarray(j_max)[keep])
    scale = float(np.abs(np.asarray(j_avg)).max())
    np.testing.assert_allclose(p_avg.numpy()[keep], np.asarray(j_avg)[keep],
                               rtol=0, atol=1e-6 * scale)
    # deterministic: a second call gives the same bits
    again = roiaware_pool.roiaware_pool3d_multi_batched(
        torch.as_tensor(rois), torch.as_tensor(pts),
        [(torch.as_tensor(favg), 'avg'), (torch.as_tensor(fmax), 'max')],
        torch.as_tensor(mask), out_size=o, max_pts_per_roi=cap)
    assert torch.equal(again[0], p_avg) and torch.equal(again[1], p_max)


# ---------------------------------------------------------- RCNN heads ---

def _rcnn_cfg(name):
    rc = copy.deepcopy(tiny_parta2_cfg(1).MODEL.RCNN)
    if name == 'FCRCNN':
        rc.NAME, rc.ROI_AWARE_POOL_SIZE, rc.SHARED_FC = 'FCRCNN', 12, [32, 64,
                                                                         64]
    return rc


@pytest.mark.parametrize('name', ['SpConvRCNN', 'FCRCNN'])
def test_rcnn_head_matches_jax(name):
    rc = _rcnn_cfg(name)
    o = int(rc.ROI_AWARE_POOL_SIZE)
    kw = dict(num_point_features=16, pool_size=o,
              shared_fc=tuple(rc.SHARED_FC), cls_fc=tuple(rc.CLS_FC),
              reg_fc=tuple(rc.REG_FC), dp_ratio=float(rc.DP_RATIO))
    jmod = (jax_roi.SpConvRCNNModule if name == 'SpConvRCNN'
            else jax_roi.FCRCNNModule)(**kw)
    rng = np.random.RandomState(3)
    occ = rng.rand(5, o, o, o) < 0.15
    part = rng.rand(5, o, o, o, 4).astype(np.float32) * occ[..., None]
    rpn = rng.randn(5, o, o, o, 16).astype(np.float32) * occ[..., None]
    template = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(part), jnp.asarray(rpn), False))
    v = _random_variables(template, 5)
    want = jmod.apply(v, jnp.asarray(part), jnp.asarray(rpn), False)

    port = (roi_heads.SpConvRCNN if name == 'SpConvRCNN'
            else roi_heads.FCRCNN)(**kw)
    sd = {}
    weights._rcnn(sd, v['params'], v['batch_stats'], rc)
    port.load_state_dict({k[len('rcnn_net.'):]: t for k, t in sd.items()})
    port.eval()
    with torch.inference_mode():
        got = port(torch.as_tensor(part), torch.as_tensor(rpn))
    for g, w_ in zip(got, want):
        _close(g.numpy(), w_, TOL)


# -------------------------------------------------------- proposal layer ---

def _head_inputs(num_class, seed):
    cfg = tiny_parta2_cfg(num_class)
    det = detect.build_detector(cfg, 'cpu', seed=0)
    anchors = det.model.anchors.numpy()
    a = anchors.shape[0]
    rng = np.random.RandomState(seed)
    cls = rng.randn(2, a, num_class).astype(np.float32) * 2
    box = (rng.randn(2, a, 7) * 0.3).astype(np.float32)
    dirp = rng.randn(2, a, 2).astype(np.float32)
    return cfg, det, anchors, cls, box, dirp


@pytest.mark.parametrize('rotated', [True, False])
@pytest.mark.parametrize('num_class', [1, 3])
def test_proposal_layer_matches_jax(num_class, rotated):
    cfg, det, anchors, cls, box, dirp = _head_inputs(num_class, num_class)
    tc = cfg.MODEL.TEST
    head_args = dict(cfg.MODEL.RPN.RPN_HEAD.ARGS)
    args = dict(nms_pre=int(tc.NMS_PRE_MAXSIZE),
                nms_post=int(tc.NMS_POST_MAXSIZE),
                nms_thresh=float(tc.RPN_NMS_THRESH), rotated=rotated)
    want = jax_roi.proposal_layer_from_head(
        jnp.asarray(cls), jnp.asarray(box), jnp.asarray(anchors),
        jnp.asarray(dirp), JaxCoder(), head_args, **args)
    got = roi_heads.proposal_layer_from_head(
        torch.as_tensor(cls), torch.as_tensor(box), torch.as_tensor(anchors),
        torch.as_tensor(dirp), ResidualCoder(), head_args, **args)
    np.testing.assert_array_equal(got['roi_valid'].numpy(),
                                  np.asarray(want['roi_valid']))
    assert got['roi_valid'].all(dim=1).all()
    np.testing.assert_array_equal(got['roi_labels'].numpy(),
                                  np.asarray(want['roi_labels']))
    if num_class == 3:
        assert len(np.unique(np.asarray(want['roi_labels']))) == 3
    # the same anchors were selected: their raw scores are equal
    np.testing.assert_array_equal(got['roi_raw_scores'].numpy(),
                                  np.asarray(want['roi_raw_scores']))
    np.testing.assert_allclose(got['rois'].numpy(), np.asarray(want['rois']),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------- post-processing ---

def _decoded(num_class, seed):
    cfg, det, anchors, cls, box, dirp = _head_inputs(num_class, seed)
    boxes = JaxCoder().decode_with_head_direction(
        jnp.asarray(box[:, :400]), jnp.asarray(anchors[None, :400]),
        jnp.asarray(dirp[:, :400]), 2, 0.78539, 0.0)
    return cfg, cls[:, :400], np.asarray(boxes)


@pytest.mark.parametrize('multi', [False, True])
@pytest.mark.parametrize('num_class', [1, 3])
def test_post_process_batch_matches_jax(num_class, multi):
    """Class-agnostic with the labels override (Part-A²'s predict: one score
    and the RoIs' labels) or per class under MULTI_CLASSES_NMS."""
    cfg, cls, boxes = _decoded(num_class, 10 + num_class)
    tc = copy.deepcopy(cfg.MODEL.TEST)
    tc.MULTI_CLASSES_NMS = multi
    tc.SCORE_THRESH = 0.3
    override = None
    if not multi:
        rng = np.random.RandomState(2)
        override = rng.randint(1, num_class + 1, cls.shape[:2]).astype(
            np.int32)
        cls = cls[..., :1]
    want = jax_det.post_process_batch(
        jnp.asarray(cls), jnp.asarray(boxes), tc,
        class_labels_override=None if override is None
        else jnp.asarray(override))
    got = detector3d.post_process_batch(
        torch.as_tensor(cls), torch.as_tensor(boxes), tc,
        class_labels_override=None if override is None
        else torch.as_tensor(override))
    assert (np.asarray(want['num']) > 0).all()
    for k in ('num', 'valid', 'labels'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ('boxes', 'scores'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
    if multi and num_class == 3:
        one = detector3d.multi_classes_nms_batched(
            torch.as_tensor(cls), torch.as_tensor(boxes), 0.3, 0.01, 512, 64)
        jone = jax_det.multi_classes_nms_batched(
            jnp.asarray(cls), jnp.asarray(boxes), 0.3, 0.01, 512, 64)
        for k in ('num', 'valid', 'labels'):
            np.testing.assert_array_equal(one[k].numpy(), np.asarray(jone[k]))
        sample = detector3d.post_process_sample(
            torch.as_tensor(cls[0]), torch.as_tensor(boxes[0]), 0.3, 0.01,
            512, 64)
        jsample = jax_det.post_process_sample(
            jnp.asarray(cls[0]), jnp.asarray(boxes[0]), 0.3, 0.01, 512, 64)
        for k in ('valid', 'labels'):
            np.testing.assert_array_equal(sample[k].numpy(),
                                          np.asarray(jsample[k]))


def test_decode_single_stage_matches_jax():
    cfg, det, anchors, cls, box, dirp = _head_inputs(3, 4)
    head_args = dict(cfg.MODEL.RPN.RPN_HEAD.ARGS)
    ret = {'box_preds': box, 'cls_preds': cls, 'dir_cls_preds': dirp}
    jc, jb = jax_det.decode_single_stage(
        {k: jnp.asarray(v) for k, v in ret.items()}, jnp.asarray(anchors),
        JaxCoder(), 3, head_args)
    pc, pb = detector3d.decode_single_stage(
        {k: torch.as_tensor(v) for k, v in ret.items()},
        torch.as_tensor(anchors), ResidualCoder(), 3, head_args)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)
