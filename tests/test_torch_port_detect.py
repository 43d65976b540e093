"""pcdet_tpu_torch PointPillar detect vs pcdet_tpu (CPU, tiny widths).

- post_process_from_head on random head outputs (class-agnostic, multi-class,
  axis-aligned NMS, sigmoid scores) against the JAX function;
- the whole slice: scan -> voxelize -> net -> predict through
  `pcdet_tpu_torch.detect.Detector`, against voxelize_jnp +
  `model.module.apply` + `model.predict`, with the flax weights carried over
  and conv_cls's bias zeroed so that detections exist;
- the port imports no jax or flax.

Detections must agree in count, valid mask and labels exactly; boxes and
scores to 1e-4 (decode runs exp / sqrt / floor through two libraries, and
the f32 convolutions sum in different orders, 1e-7 relative measured).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_config import tiny_pointpillar_cfg

from pcdet_tpu.datasets.synthetic import make_scene
from pcdet_tpu.models import detector3d as jax_det
from pcdet_tpu.models.pointpillar import PointPillar as JaxPointPillar
from pcdet_tpu.ops.voxelizer import voxelize_jnp
from pcdet_tpu.utils.box_coder import ResidualCoder as JaxCoder
from pcdet_tpu.utils.edict import EDict
from pcdet_tpu_torch import detect
from pcdet_tpu_torch.models import detector3d
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.utils.box_coder import ResidualCoder
from pcdet_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

TOL = 1e-4
REPO = Path(__file__).resolve().parent.parent


def _compare(got, want):
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got['num'], want['num'])
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    np.testing.assert_allclose(got['boxes'], want['boxes'], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got['scores'], want['scores'], rtol=TOL,
                               atol=TOL)


def _heads(rng, batch, num_anchors, num_class):
    return {
        'cls_preds': rng.randn(batch, num_anchors, num_class).astype(
            np.float32) * 2,
        'box_preds': rng.randn(batch, num_anchors, 7).astype(np.float32) * 0.2,
        'dir_cls_preds': rng.randn(batch, num_anchors, 2).astype(np.float32),
    }


@pytest.mark.parametrize('extra', [
    {},
    {'MULTI_CLASSES_NMS': True},
    {'NMS_TYPE': 'nms_normal_gpu'},
    {'USE_RAW_SCORE': False, 'SCORE_THRESH': 0.3},
    {'NMS_PRE_MAXSIZE_LAST': 4096},        # pre above the anchor count
])
def test_post_process_from_head_matches_jax(extra):
    rng = np.random.RandomState(0)
    num_anchors, num_class = 600, 3
    anchors = np.concatenate([
        rng.uniform(-40, 40, (num_anchors, 2)),
        rng.uniform(-2, 0, (num_anchors, 1)),
        rng.uniform(1.0, 4.0, (num_anchors, 3)),
        rng.uniform(-np.pi, np.pi, (num_anchors, 1)),
    ], axis=1).astype(np.float32)
    heads = _heads(rng, 2, num_anchors, num_class)
    head_args = {'num_direction_bins': 2, 'dir_offset': 0.78539,
                 'dir_limit_offset': 0.0, 'use_binary_dir_classifier': False}
    tc = EDict({'SCORE_THRESH': 0.1, 'NMS_THRESH': 0.3,
                'NMS_PRE_MAXSIZE_LAST': 128, 'NMS_POST_MAXSIZE_LAST': 32,
                **extra})
    want = jax_det.post_process_from_head(
        {k: jnp.asarray(v) for k, v in heads.items()}, jnp.asarray(anchors),
        JaxCoder(), num_class, head_args, tc)
    got = detector3d.post_process_from_head(
        {k: torch.as_tensor(v) for k, v in heads.items()},
        torch.as_tensor(anchors), ResidualCoder(), num_class, head_args, tc)
    assert (np.asarray(want['num']) > 0).all()
    _compare(got, want)


def test_post_process_class_labels_override_matches_jax():
    rng = np.random.RandomState(2)
    num_anchors = 400
    anchors = np.concatenate([
        rng.uniform(-30, 30, (num_anchors, 2)),
        rng.uniform(-2, 0, (num_anchors, 1)),
        rng.uniform(1.0, 4.0, (num_anchors, 3)),
        rng.uniform(-np.pi, np.pi, (num_anchors, 1)),
    ], axis=1).astype(np.float32)
    heads = _heads(rng, 2, num_anchors, 1)
    labels = rng.randint(1, 4, (2, num_anchors)).astype(np.int32)
    head_args = {'num_direction_bins': 2, 'dir_offset': 0.78539,
                 'dir_limit_offset': 0.0}
    tc = EDict({'SCORE_THRESH': 0.1, 'NMS_THRESH': 0.3,
                'NMS_PRE_MAXSIZE_LAST': 100, 'NMS_POST_MAXSIZE_LAST': 30})
    want = jax_det.post_process_from_head(
        {k: jnp.asarray(v) for k, v in heads.items()}, jnp.asarray(anchors),
        JaxCoder(), 1, head_args, tc,
        class_labels_override=jnp.asarray(labels))
    got = detector3d.post_process_from_head(
        {k: torch.as_tensor(v) for k, v in heads.items()},
        torch.as_tensor(anchors), ResidualCoder(), 1, head_args, tc,
        class_labels_override=torch.as_tensor(labels))
    assert len(np.unique(np.asarray(want['labels']))) > 2
    _compare(got, want)


@pytest.mark.parametrize('binary_dir', [False, True])
def test_decode_with_head_direction_matches_jax(binary_dir):
    rng = np.random.RandomState(1)
    enc = rng.randn(2, 50, 7).astype(np.float32) * 0.3
    anchors = np.concatenate([rng.uniform(-40, 40, (2, 50, 3)),
                              rng.uniform(0.5, 4.0, (2, 50, 3)),
                              rng.uniform(-np.pi, np.pi, (2, 50, 1))],
                             axis=-1).astype(np.float32)
    dirs = rng.randn(2, 50, 2).astype(np.float32)
    args = dict(num_dir_bins=2, dir_offset=0.78539, dir_limit_offset=0.0,
                use_binary_dir_classifier=binary_dir)
    want = np.asarray(JaxCoder().decode_with_head_direction(
        jnp.asarray(enc), jnp.asarray(anchors), jnp.asarray(dirs), **args))
    got = ResidualCoder().decode_with_head_direction(
        torch.as_tensor(enc), torch.as_tensor(anchors), torch.as_tensor(dirs),
        **args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_detect_slice_matches_jax():
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

    det = detect.build_detector(cfg, 'cpu', seed=0)
    jmodel = JaxPointPillar(cfg, grid_size(det.voxel_size, det.pc_range))
    vox = jax.vmap(lambda q, m: voxelize_jnp(
        q, m, det.voxel_size, det.pc_range, det.max_points_per_voxel,
        det.max_voxels))(jnp.asarray(points), jnp.asarray(mask))
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
    det.model.module.load_state_dict(state_dict_from_flax(
        variables, cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']))

    ret = jmodel.module.apply(variables, vox['voxels'],
                              vox['num_points_per_voxel'],
                              vox['coordinates'], vox['voxel_mask'], False)
    want = jmodel.predict(ret)
    got = det.detect(torch.as_tensor(points), torch.as_tensor(mask))
    assert (np.asarray(want['num']) > 0).all()
    _compare(got, want)


def test_port_imports_no_jax():
    code = ('import sys, chip_smoke, pcdet_tpu_torch, pcdet_tpu_torch.detect, '
            'pcdet_tpu_torch.weights, pcdet_tpu_torch.ops.nms, '
            'pcdet_tpu_torch.ops.gather_gemm, pcdet_tpu_torch.ops.sparse, '
            'pcdet_tpu_torch.ops.host_books, pcdet_tpu_torch.models.second, '
            'pcdet_tpu_torch.models.backbones3d, pcdet_tpu_torch.ops.gather_dw, '
            'pcdet_tpu_torch.utils.loss, pcdet_tpu_torch.train.trainer; '
            'bad = sorted(m for m in sys.modules '
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax')); "
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('checks the refusal on a machine without a card')
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
