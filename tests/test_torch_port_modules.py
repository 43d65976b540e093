"""pcdet_tpu_torch PointPillar modules vs pcdet_tpu (CPU, tiny widths).

PillarFeatureNet, pillar_scatter, RPNV2 and the whole PointPillarNet, with
the JAX package's flax variables (BN parameters and statistics randomised
from a numpy seed) carried over by `weights.state_dict_from_flax`, on the
same voxels.  Also the weight bridge's round trip through
`pcdet_tpu.train.torch_import`.

Tolerances:
- f32: rtol = atol = 1e-4 (the two frameworks' convolutions and matmuls sum
  in different orders);
- the shipped bf16 eval stack: max |diff| / max |ref| < 3e-2, the bound
  test_rpn_bf16.py holds bf16 to f32 at.  JAX convolves bf16 with an f32
  result; torch returns bf16, one more rounding per conv (see
  pcdet_tpu_torch/models/layers.py);
- the scatter moves values and must be exact.
"""
import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_config import tiny_pointpillar_cfg

from pcdet_tpu.datasets.synthetic import make_scene
from pcdet_tpu.models import pillar_scatter as jax_scatter
from pcdet_tpu.models.pointpillar import PointPillar as JaxPointPillar
from pcdet_tpu.models.rpn_head import RPNV2 as JaxRPNV2
from pcdet_tpu.models.vfe import PillarFeatureNet as JaxPFN
from pcdet_tpu.ops.voxelizer import VoxelGenerator, voxelize_jnp
from pcdet_tpu.train import torch_import
from pcdet_tpu_torch.models.pillar_scatter import pillar_scatter
from pcdet_tpu_torch.models.pointpillar import PointPillar
from pcdet_tpu_torch.models.second import SECONDNet
from pcdet_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
BF16_REL = 3e-2
HEADS = ('box_preds', 'cls_preds', 'dir_cls_preds')


def _randomise_bn(tree, stats, rng):
    """Non-trivial BN scale / bias / mean / var in place (numpy trees)."""
    for k, v in tree.items():
        if k.startswith('TorchBatchNorm'):
            n = v['scale'].shape[0]
            v['scale'] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            v['bias'] = rng.normal(0, 0.1, n).astype(np.float32)
            stats[k]['mean'] = rng.normal(0, 0.1, n).astype(np.float32)
            stats[k]['var'] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        elif isinstance(v, dict) and k in stats:
            _randomise_bn(v, stats[k], rng)


def _setup(compute_dtype='', num_class=1, vfe_args=None, rpn_args=None):
    cfg = tiny_pointpillar_cfg(num_class=num_class)
    cfg.MODEL.RPN.RPN_HEAD.ARGS['compute_dtype_test'] = compute_dtype
    cfg.MODEL.VFE.ARGS.update(vfe_args or {})
    cfg.MODEL.RPN.RPN_HEAD.ARGS.update(rpn_args or {})
    dc = cfg.DATA_CONFIG
    vg = VoxelGenerator(dc.VOXEL_GENERATOR.VOXEL_SIZE, dc.POINT_CLOUD_RANGE,
                        dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL,
                        dc.TEST.MAX_NUMBER_OF_VOXELS)
    jmodel = JaxPointPillar(cfg, vg.grid_size)

    rng = np.random.RandomState(0)
    p = int(dc.MAX_POINTS)
    points = np.zeros((2, p, 4), np.float32)
    mask = np.zeros((2, p), bool)
    for i in range(2):
        pts, _, _ = make_scene(rng, list(cfg.CLASS_NAMES), num_objects=4,
                               x_range=(3, 30), y_range=(-14, 14))
        n = min(len(pts), p)
        points[i, :n], mask[i, :n] = pts[:n], True
    vox = jax.vmap(lambda q, m: voxelize_jnp(
        q, m, tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE),
        tuple(dc.POINT_CLOUD_RANGE), int(dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL),
        int(dc.TEST.MAX_NUMBER_OF_VOXELS)))(jnp.asarray(points),
                                           jnp.asarray(mask))
    batch = {'voxels': vox['voxels'], 'num_points': vox['num_points_per_voxel'],
             'coordinates': vox['coordinates'], 'voxel_mask': vox['voxel_mask']}
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init_variables(jax.random.PRNGKey(0), batch))
    variables = {k: dict(v) for k, v in variables.items()}
    _randomise_bn(variables['params'], variables.get('batch_stats', {}), rng)

    tmodel = PointPillar(cfg, vg.grid_size, device='cpu')
    layer_nums = cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']
    tmodel.module.load_state_dict(state_dict_from_flax(variables, layer_nums))
    vox_np = {k: np.asarray(v) for k, v in vox.items()}
    return cfg, jmodel, tmodel, variables, vox_np


@pytest.fixture(scope='module')
def f32():
    return _setup()


def _t(x):
    return torch.as_tensor(np.array(x))


def test_pillar_feature_net(f32):
    cfg, jmodel, tmodel, variables, vox = f32
    m = jmodel.module
    jpfn = JaxPFN(num_filters=tuple(m.vfe_num_filters), use_norm=m.use_norm,
                  with_distance=m.vfe_with_distance,
                  voxel_size=tuple(m.voxel_size), pc_range=tuple(m.pc_range))
    want = np.asarray(jpfn.apply(
        {'params': variables['params']['vfe'],
         'batch_stats': variables['batch_stats']['vfe']},
        vox['voxels'], vox['num_points_per_voxel'], vox['coordinates'],
        vox['voxel_mask'], False))
    with torch.no_grad():
        got = tmodel.module.vfe(_t(vox['voxels']),
                                _t(vox['num_points_per_voxel']),
                                _t(vox['coordinates']),
                                _t(vox['voxel_mask'])).numpy()
    assert vox['voxel_mask'].sum() > 100
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pillar_scatter_exact(f32):
    cfg, jmodel, tmodel, variables, vox = f32
    rng = np.random.RandomState(1)
    feats = rng.randn(*vox['voxel_mask'].shape, 8).astype(np.float32)
    ny, nx = jmodel.module.grid_ny, jmodel.module.grid_nx
    want = np.asarray(jax_scatter.pillar_scatter(
        jnp.asarray(feats), jnp.asarray(vox['coordinates']),
        jnp.asarray(vox['voxel_mask']), ny, nx))
    got = pillar_scatter(_t(feats), _t(vox['coordinates']),
                         _t(vox['voxel_mask']), ny, nx)
    assert got.is_contiguous()
    assert got.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_rpn(jmodel, compute_dtype):
    a = jmodel.head_args
    return JaxRPNV2(
        num_class=jmodel.num_class,
        num_anchors_per_location=jmodel.anchor_targets.num_anchors_per_location,
        layer_nums=tuple(a['layer_nums']), layer_strides=tuple(a['layer_strides']),
        num_filters=tuple(a['num_filters']),
        upsample_strides=tuple(a['upsample_strides']),
        num_upsample_filters=tuple(a['num_upsample_filters']),
        compute_dtype_test=compute_dtype)


def test_rpnv2_heads_f32(f32):
    cfg, jmodel, tmodel, variables, vox = f32
    rng = np.random.RandomState(2)
    ny, nx = jmodel.module.grid_ny, jmodel.module.grid_nx
    canvas = np.maximum(rng.randn(2, ny, nx, 32), 0).astype(np.float32)
    want = _jax_rpn(jmodel, '').apply(
        {'params': variables['params']['rpn_head'],
         'batch_stats': variables['batch_stats']['rpn_head']},
        jnp.asarray(canvas), False)
    with torch.no_grad():
        got = tmodel.module.rpn_head(_t(canvas))
    for k in HEADS:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_whole_net_f32(f32):
    cfg, jmodel, tmodel, variables, vox = f32
    want = jmodel.module.apply(variables, vox['voxels'],
                               vox['num_points_per_voxel'],
                               vox['coordinates'], vox['voxel_mask'], False)
    with torch.no_grad():
        got = tmodel.forward({k: _t(v) for k, v in vox.items()})
    for k in HEADS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize('variant', [
    # two PFN layers (the non-last layer's concat path) and the distance
    # feature; three classes (6 anchors per location)
    dict(num_class=3, vfe_args={'num_filters': [16, 32],
                                'with_distance': True}),
    # no BatchNorm anywhere (biased linears / convs) and the raw canvas
    # concatenated before the heads (stride-1 first block, so the canvas and
    # the upsampled maps share a resolution)
    dict(vfe_args={'use_norm': False},
         rpn_args={'use_norm': False, 'concat_input': True,
                   'layer_strides': [1, 2]}),
])
def test_whole_net_f32_variants(variant):
    cfg, jmodel, tmodel, variables, vox = _setup(**variant)
    want = jmodel.module.apply(variables, vox['voxels'],
                               vox['num_points_per_voxel'],
                               vox['coordinates'], vox['voxel_mask'], False)
    with torch.no_grad():
        got = tmodel.forward({k: _t(v) for k, v in vox.items()})
    for k in HEADS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_whole_net_bf16_within_bf16_rounding():
    cfg, jmodel, tmodel, variables, vox = _setup('bfloat16')
    want = jmodel.module.apply(variables, vox['voxels'],
                               vox['num_points_per_voxel'],
                               vox['coordinates'], vox['voxel_mask'], False)
    with torch.no_grad():
        got = tmodel.forward({k: _t(v) for k, v in vox.items()})
    assert tmodel.module.canvas_dtype == torch.bfloat16
    for k in HEADS:
        a, b = np.asarray(want[k]), got[k].float().numpy()
        rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-3)
        assert rel < BF16_REL, (k, rel)


def test_weight_bridge_round_trip(f32):
    """port state_dict -> torch_import.convert_state_dict -> the original
    flax variables, every key used."""
    cfg, jmodel, tmodel, variables, vox = f32
    sd = {k: v.numpy() for k, v in tmodel.module.state_dict().items()}
    back, unused = torch_import.convert_state_dict(sd, jmodel)
    assert unused == []
    flat_back = dict(torch_import._flatten(back))
    flat_orig = dict(torch_import._flatten(copy.deepcopy(variables)))
    assert sorted(flat_back) == sorted(flat_orig)
    for path, v in flat_orig.items():
        np.testing.assert_array_equal(flat_back[path], v,
                                      err_msg='/'.join(path))


def test_model_classes_default_to_the_card():
    """The model classes, like the detector and trainer entry points, run on
    the card unless the caller asks for the CPU, as these tests do."""
    for cls in (PointPillar, SECONDNet):
        assert inspect.signature(cls).parameters['device'].default == 'cuda'
