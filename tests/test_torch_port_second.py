"""pcdet_tpu_torch SECOND detect vs pcdet_tpu (CPU, tiny_second_cfg, B=2).

The same flax variables (random, from the init's shapes, with random BN
statistics and conv_cls's bias zeroed so that detections exist) run
through `pcdet_tpu.models.second.SECONDNet` (voxelize_jnp, host books,
`module.apply`, `predict`) and through the port's
`detect.build_detector(cfg).detect`, which voxelizes, builds and uploads
the books itself.

- f32: the BEV and the heads to 1e-4 of their largest value; detections
  equal in count, valid mask and labels, boxes and scores to 1e-4 (the
  sparse convs agree to 1e-7 relative, the rest as PointPillar's slice);
- bf16 backbone and RPN (the shipped eval dtype): heads within 3e-2 of
  their largest value, PointPillar's bf16 bound (cuDNN rounds each dense
  conv's output to bf16 once more than JAX);
- the loader path (`hb_*` books in the batch) gives what detect gives;
- the port's state_dict converts back to the same flax variables through
  `pcdet_tpu.train.torch_import.convert_state_dict`, with no unused key.
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
from pcdet_tpu.train import torch_import
from pcdet_tpu_torch import detect
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

TOL = 1e-4
BF16_TOL = 3e-2
HEADS = ('box_preds', 'cls_preds', 'dir_cls_preds')


def _scans(cfg):
    rng = np.random.RandomState(0)
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
    random BN affine and statistics, conv_cls's bias zero."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        names = [getattr(p, 'key', '') for p in path]
        shape = leaf.shape
        if names[-1] == 'kernel':
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if names[-1] == 'bias' and 'conv_cls' in names:
            return np.zeros(shape, np.float32)
        if names[-1] in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


def _run(cfg, points, mask, seed=0):
    """JAX reference outputs and the port's, on the same variables."""
    dc = cfg.DATA_CONFIG
    vs = tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE)
    pr = tuple(dc.POINT_CLOUD_RANGE)
    cap = int(dc.TEST.MAX_NUMBER_OF_VOXELS)
    jmodel = JaxSECONDNet(cfg, grid_size(vs, pr))
    vox = jax.vmap(lambda q, m: voxelize_jnp(
        q, m, vs, pr, int(dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL), cap))(
            jnp.asarray(points), jnp.asarray(mask))
    batch = {'voxels': vox['voxels'], 'num_points': vox['num_points_per_voxel'],
             'coordinates': vox['coordinates'],
             'voxel_mask': vox['voxel_mask']}
    template = jax.eval_shape(
        lambda: jmodel.init_variables(jax.random.PRNGKey(0), batch))
    variables = _random_variables(template, seed)
    flat = jax_books.build_books_batch(
        np.asarray(vox['coordinates']), np.asarray(vox['voxel_mask']),
        jmodel.sparse_shape, jmodel.host_book_spec(cap, False))
    batch.update({k: jnp.asarray(v) for k, v in flat.items()})
    ret, _ = jmodel.forward(variables, batch, train=False)
    want = jmodel.predict(ret)

    det = detect.build_detector(cfg, 'cpu', seed=0)
    det.model.module.load_state_dict(state_dict_from_flax(
        variables, cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']))
    pts, msk = torch.as_tensor(points), torch.as_tensor(mask)
    with torch.inference_mode():
        vox_t = det.voxelize(pts, msk)
        vox_t['books'] = det.books(vox_t)
        port_ret = det.model.forward(vox_t)
    got = det.detect(pts, msk)
    return {'jax_model': jmodel, 'variables': variables, 'det': det,
            'ret': ret, 'want': want, 'port_ret': port_ret, 'got': got,
            'flat': flat}


@pytest.fixture(scope='module')
def f32():
    cfg = tiny_second_cfg(num_class=1)
    points, mask = _scans(cfg)
    return _run(cfg, points, mask)


@pytest.fixture(scope='module')
def bf16():
    cfg = tiny_second_cfg(num_class=1)
    cfg.MODEL.RPN.BACKBONE.ARGS['compute_dtype_test'] = 'bfloat16'
    cfg.MODEL.RPN.RPN_HEAD.ARGS['compute_dtype_test'] = 'bfloat16'
    points, mask = _scans(cfg)
    return _run(cfg, points, mask)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_backbone_bev_and_heads_f32(f32):
    ret, port = f32['ret'], f32['port_ret']
    bev = port['spatial_features']
    assert bev.shape == (2, 16, 16, 128)          # 128 * D, D = 1 here
    _close(bev.numpy(), ret['spatial_features'], TOL)
    for k in HEADS:
        _close(port[k].numpy(), ret[k], TOL)
    for name, drops in port['overflow'].items():
        np.testing.assert_array_equal(drops.numpy(),
                                      np.asarray(ret['overflow'][name]))


def test_detect_matches_jax_f32(f32):
    want = {k: np.asarray(v) for k, v in f32['want'].items()}
    got = {k: v.numpy() for k, v in f32['got'].items()}
    assert (want['num'] > 0).all()
    np.testing.assert_array_equal(got['num'], want['num'])
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    np.testing.assert_allclose(got['boxes'], want['boxes'], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got['scores'], want['scores'], rtol=TOL,
                               atol=TOL)


def test_heads_match_jax_bf16(bf16, f32):
    ret, port = bf16['ret'], bf16['port_ret']
    _close(port['spatial_features'].numpy(), ret['spatial_features'],
           BF16_TOL)
    for k in HEADS:
        _close(port[k].numpy(), ret[k], BF16_TOL)
        # the bf16 path really ran: it is not the f32 result
        assert not np.allclose(np.asarray(ret[k]),
                               np.asarray(f32['ret'][k]), rtol=0, atol=1e-6)


def test_loader_books_path_matches_detect(f32):
    det = f32['det']
    points, mask = _scans(det.model.cfg)
    batch = det.voxelize(torch.as_tensor(points), torch.as_tensor(mask))
    batch.update(f32['flat'])                     # the loader's hb_* arrays
    got = det.detect_batch(batch)
    for k, v in f32['got'].items():
        assert torch.equal(got[k], v), k


def test_state_dict_round_trip(f32):
    sd = {k: v.numpy() for k, v in
          f32['det'].model.module.state_dict().items()}
    variables, unused = torch_import.convert_state_dict(sd, f32['jax_model'])
    assert unused == []
    want = jax.tree_util.tree_leaves_with_path(f32['variables'])
    got = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)


def test_build_detector_dispatch():
    cfg = tiny_second_cfg(num_class=1)
    assert isinstance(detect.build_detector(cfg, 'cpu'),
                      detect.SparseDetector)
    bad = copy.deepcopy(cfg)
    bad.MODEL.NAME = 'PointRCNN'
    with pytest.raises(NotImplementedError, match='no port of model'):
        detect.build_detector(bad, 'cpu')
