"""pcdet_tpu_torch's evaluation path vs pcdet_tpu (CPU, small sizes).

- kernel A″'s plain version (`rotated_overlap.pair_overlap_sorted_plain`)
  against the Pallas `pair_overlap_sorted` run in interpret mode, on 12 x
  140 random boxes within 6 m and on crafted degenerate pairs (identical,
  a shared edge, contained, disjoint, a square turned 90°): atol 2e-5 (the
  sums over the 24 candidates run in another order in XLA; 1.9e-6
  measured); and against kernel A's plain version, the other method, to
  the same bound;
- `quad_intersection_area_sort` against pcdet_tpu's, atol 2e-5;
- `boxes_iou3d` and `boxes_iou3d_batched` against pcdet_tpu's
  `boxes_iou3d` per sample, atol 1e-5;
- `recall_counts` and `batch_recall` equal to pcdet_tpu's `recall_counts`
  and `eval_loop._batch_recall`, exactly, on fabricated detections (GT
  boxes jittered by a few cm to a metre, and false positives);
- the evaluator's copy: the same annotations and fabricated detections give
  the identical AP string and dict;
- the whole slice on `tiny_pointpillar_cfg` / `tiny_second_cfg` (3 classes)
  with the flax weights carried across: pcdet_tpu's chain (voxelize_jnp,
  the model, predict, `_batch_recall`, `generate_annotations`,
  `evaluation`) against the port.  pcdet_tpu's predictions fed to the
  port's recall and evaluator give its counts and AP string exactly; the
  port's `eval_one_epoch` end to end gives the same recall counts and AP
  string.
"""
import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tiny_config import tiny_pointpillar_cfg, tiny_second_cfg

from pcdet_tpu.datasets import synthetic as jax_synthetic
from pcdet_tpu.datasets.kitti.kitti_eval import eval as jax_kitti_eval
from pcdet_tpu.models import detector3d as jax_det
from pcdet_tpu.models.pointpillar import PointPillar as JaxPointPillar
from pcdet_tpu.models.second import SECONDNet as JaxSECONDNet
from pcdet_tpu.ops import host_books as jax_books
from pcdet_tpu.ops import rotated_iou as jax_iou
from pcdet_tpu.ops.pallas import rotated_overlap as jax_overlap
from pcdet_tpu.ops.voxelizer import voxelize_jnp
from pcdet_tpu.train import eval_loop as jax_eval_loop
from pcdet_tpu_torch import detect
from pcdet_tpu_torch.datasets.kitti.kitti_eval import eval as kitti_eval
from pcdet_tpu_torch.datasets.synthetic import SyntheticDataset, eval_batches
from pcdet_tpu_torch.models import detector3d
from pcdet_tpu_torch.ops import rotated_iou, rotated_overlap
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.train.eval_loop import eval_one_epoch
from pcdet_tpu_torch.weights import state_dict_from_flax

from test_torch_port_second import _random_variables

torch.set_num_threads(1)

AREA_TOL = 2e-5
IOU_TOL = 1e-5
CLASSES = ['Car', 'Pedestrian', 'Cyclist']


def _boxes5(rng, n, scale=6.0):
    cx = rng.uniform(-scale, scale, n)
    cy = rng.uniform(-scale, scale, n)
    dx = rng.uniform(0.5, 5.0, n)
    dy = rng.uniform(0.5, 5.0, n)
    ang = rng.uniform(-np.pi, np.pi, n)
    return np.stack([cx - dx / 2, cy - dy / 2, cx + dx / 2, cy + dy / 2, ang],
                    axis=1).astype(np.float32)


def _crafted():
    a = np.array([[-5, -5, 5, 5, 0.0]] * 5 + [[0, 0, 2, 4, 0.7]], np.float32)
    b = np.array([[-1, -1, 1, 1, 0.9],          # contained, rotated
                  [5, -1, 7, 1, 0.0],            # shares an edge: area 0
                  [100, 100, 102, 102, 0.3],     # disjoint
                  [-5, -5, 5, 5, np.pi / 2],     # same square turned 90°
                  [-5, -5, 5, 5, 0.0],           # identical
                  [0, 0, 2, 4, 0.7]], np.float32)  # identical, rotated
    return a, b


def _corners(case):
    if case == 'random':
        rng = np.random.RandomState(0)
        a, b = _boxes5(rng, 12), _boxes5(rng, 140)
    else:
        a, b = _crafted()
    return (np.asarray(jax_iou.boxes5_to_corners(jnp.asarray(a))),
            np.asarray(jax_iou.boxes5_to_corners(jnp.asarray(b))))


@pytest.mark.parametrize('case', ['random', 'crafted'])
def test_pair_overlap_sorted_plain_matches_pallas(case):
    ca, cb = _corners(case)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_overlap.pair_overlap_sorted(jnp.asarray(ca),
                                                          jnp.asarray(cb)))
    got = rotated_overlap.pair_overlap_sorted(torch.tensor(ca),
                                              torch.tensor(cb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=AREA_TOL)
    if case == 'random':
        assert (want > 0).sum() > 100
    else:
        np.testing.assert_allclose(np.diag(got), [4, 0, 0, 100, 100, 8],
                                   rtol=1e-5, atol=AREA_TOL)
    # the other method, kernel A's plain version, to the same bound
    edge = rotated_overlap.pair_overlap(torch.tensor(ca),
                                        torch.tensor(cb)).numpy()
    np.testing.assert_allclose(got, edge, rtol=0, atol=AREA_TOL)


@pytest.mark.parametrize('case', ['random', 'crafted'])
def test_quad_intersection_area_sort_matches_jax(case):
    ca, cb = _corners(case)
    want = np.asarray(jax_iou.quad_intersection_area_sort(
        jnp.asarray(ca)[:, None], jnp.asarray(cb)[None]))
    got = rotated_iou.quad_intersection_area_sort(
        torch.tensor(ca)[:, None], torch.tensor(cb)[None]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=AREA_TOL)
    sorted_plain = rotated_overlap.pair_overlap_sorted(
        torch.tensor(ca), torch.tensor(cb)).numpy()
    np.testing.assert_allclose(sorted_plain, got, rtol=0, atol=AREA_TOL)


def test_sorted_wrapper_takes_plain_on_cpu_and_counts_no_launch():
    ca, cb = _corners('random')
    a = torch.tensor(ca)[None].repeat(2, 1, 1, 1)
    b = torch.tensor(cb)[None].repeat(2, 1, 1, 1)
    before = rotated_overlap.LAUNCHES_SORTED
    got = rotated_overlap.pair_overlap_sorted_batched(a, b)
    assert rotated_overlap.LAUNCHES_SORTED == before
    assert got.shape == (2, 12, 140)
    assert torch.equal(got, rotated_overlap.pair_overlap_sorted_plain(a, b))
    assert torch.equal(got[1], rotated_overlap.pair_overlap_sorted(a[1],
                                                                   b[1]))


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'groups', 'strides',
                                 'device'])
def test_sorted_wrapper_rejects_bad_input(bad):
    c = torch.zeros(2, 8, 4, 2)
    a, b = c[:, :4].contiguous(), c
    if bad == 'device':               # neither the CPU nor a CUDA device
        a, b = a.to('meta'), b.to('meta')
    elif bad == 'dtype':
        a = a.double()
    elif bad == 'shape':
        a = a.reshape(2, 4, 8)
    elif bad == 'groups':
        a = a[:1]
    else:
        a = torch.zeros(2, 4, 2, 4).transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        rotated_overlap.pair_overlap_sorted_batched(a, b)


def _boxes7(rng, b, n, spread=20.0):
    return np.concatenate([
        rng.uniform(-spread, spread, (b, n, 2)),
        rng.uniform(-2.0, 0.0, (b, n, 1)),
        rng.uniform(0.5, 4.5, (b, n, 3)),
        rng.uniform(-np.pi, np.pi, (b, n, 1))], axis=-1).astype(np.float32)


def _fabricated(rng, b=3, k=40, g=16):
    """GT (B, G, 8) with zero padding, and detections: GT boxes jittered by
    a few cm (recalled at 0.7), by up to a metre (some at 0.5), and random
    false positives; a valid mask and random scores and labels."""
    gt = np.zeros((b, g, 8), np.float32)
    boxes = _boxes7(rng, b, k)
    valid = rng.rand(b, k) > 0.2
    for i in range(b):
        n = g - 3 * i
        gt[i, :n, :7] = _boxes7(rng, 1, n)[0]
        gt[i, :n, 7] = rng.randint(1, 4, n)
        m = min(n, k // 2)
        scale = np.where(np.arange(m) % 2 == 0, 0.03, 0.6)[:, None]
        boxes[i, :m] = gt[i, :m, :7] + rng.uniform(-1, 1, (m, 7)) * scale
    scores = rng.rand(b, k).astype(np.float32)
    labels = rng.randint(1, 4, (b, k)).astype(np.int32)
    return gt, boxes, valid, scores, labels


def test_boxes_iou3d_matches_jax():
    rng = np.random.RandomState(1)
    a, b = _boxes7(rng, 2, 30, 8.0), _boxes7(rng, 2, 25, 8.0)
    want = np.stack([np.asarray(jax_iou.boxes_iou3d(jnp.asarray(a[i]),
                                                    jnp.asarray(b[i])))
                     for i in range(2)])
    assert (want > 0.05).sum() > 10
    got = rotated_iou.boxes_iou3d_batched(torch.tensor(a),
                                          torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_TOL)
    one = rotated_iou.boxes_iou3d(torch.tensor(a[1]), torch.tensor(b[1]))
    np.testing.assert_allclose(one.numpy(), want[1], rtol=0, atol=IOU_TOL)


def test_recall_counts_match_jax():
    rng = np.random.RandomState(2)
    gt, boxes, valid, _, _ = _fabricated(rng)
    thresh = (0.3, 0.5, 0.7)
    want = jax_eval_loop._batch_recall(jnp.asarray(boxes), jnp.asarray(valid),
                                       jnp.asarray(gt), thresh)
    got = detector3d.batch_recall(torch.tensor(boxes), torch.tensor(valid),
                                  torch.tensor(gt), thresh)
    assert sorted(got) == sorted(want)
    assert {k: int(v) for k, v in got.items()} == {
        k: int(v) for k, v in want.items()}
    assert 0 < int(got['rcnn_0.7']) < int(got['rcnn_0.3']) < int(got['gt'])
    for i in range(gt.shape[0]):
        w = jax_det.recall_counts(jnp.asarray(boxes[i]), jnp.asarray(valid[i]),
                                  jnp.asarray(gt[i]), thresh)
        g = detector3d.recall_counts(torch.tensor(boxes[i]),
                                     torch.tensor(valid[i]),
                                     torch.tensor(gt[i]), thresh)
        assert {k: int(v) for k, v in g.items()} == {
            k: int(v) for k, v in w.items()}


def _eval_cfg(make_cfg):
    cfg = make_cfg(num_class=3)
    cfg.DATA_CONFIG.SYNTHETIC = {'NUM_SAMPLES': 5, 'NUM_OBJECTS': 8}
    return cfg


def _jax_dataset(cfg):
    cfg = copy.deepcopy(cfg)
    cfg.TORCH_VOXEL_GENERATOR = True
    return jax_synthetic.SyntheticDataset(cfg, training=False)


def _host_preds(preds):
    return {k: np.asarray(v) for k, v in preds.items()}


def test_evaluator_matches_pcdet_tpu():
    cfg = _eval_cfg(tiny_pointpillar_cfg)
    port_ds, jax_ds = SyntheticDataset(cfg), _jax_dataset(cfg)
    rng = np.random.RandomState(3)
    port_annos, jax_annos = [], []
    for start in range(0, len(port_ds), 2):
        idx = list(range(start, min(start + 2, len(port_ds))))
        batch = {'batch_size': len(idx), 'sample_idx': np.array(idx)}
        gt = np.stack([port_ds[i]['gt_boxes'] for i in idx])
        _, boxes, valid, scores, labels = _fabricated(rng, len(idx), 30,
                                                      gt.shape[1])
        n = min(15, gt.shape[1])
        # jittered GT as the first detections, with their labels
        boxes[:, :n] = gt[:, :n, :7] + rng.uniform(-0.2, 0.2, (len(idx), n,
                                                               7))
        labels[:, :n] = np.maximum(gt[:, :n, 7], 1)
        preds = {'boxes': boxes, 'valid': valid, 'scores': scores,
                 'labels': labels}
        port_annos += port_ds.generate_annotations(batch, preds, CLASSES)
        jax_annos += jax_ds.generate_annotations(batch, preds, CLASSES)
    want_str, want = jax_ds.evaluation(jax_annos, CLASSES)
    got_str, got = port_ds.evaluation(port_annos, CLASSES)
    assert got_str == want_str
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    assert max(want.values()) > 10.0
    # the evaluator's module on its own, the detections as the GT
    s1, d1 = kitti_eval.get_official_eval_result(port_ds.gt_annos(),
                                                 port_ds.gt_annos(), CLASSES)
    s2, d2 = jax_kitti_eval.get_official_eval_result(jax_ds.gt_annos(),
                                                     jax_ds.gt_annos(),
                                                     CLASSES)
    assert s1 == s2 and d1 == d2


def _jax_slice(cfg, batches):
    """pcdet_tpu's eval chain on the batches, with random flax variables:
    (variables, per-batch host predictions, recall counters)."""
    dc = cfg.DATA_CONFIG
    vs = tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE)
    pr = tuple(dc.POINT_CLOUD_RANGE)
    cap = int(dc.TEST.MAX_NUMBER_OF_VOXELS)
    mpv = int(dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL)
    second = cfg.MODEL.NAME == 'second_net'
    jmodel = (JaxSECONDNet if second else JaxPointPillar)(cfg,
                                                          grid_size(vs, pr))
    variables, preds, recall = None, [], None
    thresh = tuple(cfg.MODEL.TEST.RECALL_THRESH_LIST)
    for batch in batches:
        vox = jax.vmap(lambda q, m: voxelize_jnp(q, m, vs, pr, mpv, cap))(
            jnp.asarray(batch['points']), jnp.asarray(batch['point_mask']))
        jb = {'voxels': vox['voxels'],
              'num_points': vox['num_points_per_voxel'],
              'coordinates': vox['coordinates'],
              'voxel_mask': vox['voxel_mask']}
        if variables is None:
            template = jax.eval_shape(
                lambda: jmodel.init_variables(jax.random.PRNGKey(0), jb))
            variables = _random_variables(template, 0)
        if second:
            flat = jax_books.build_books_batch(
                np.asarray(vox['coordinates']), np.asarray(vox['voxel_mask']),
                jmodel.sparse_shape, jmodel.host_book_spec(cap, False))
            jb.update({k: jnp.asarray(v) for k, v in flat.items()})
            ret, _ = jmodel.forward(variables, jb, train=False)
        else:
            ret = jmodel.module.apply(variables, jb['voxels'],
                                      jb['num_points'], jb['coordinates'],
                                      jb['voxel_mask'], False)
        p = jmodel.predict(ret)
        rc = jax_eval_loop._batch_recall(p['boxes'], p['valid'],
                                         jnp.asarray(batch['gt_boxes']),
                                         thresh)
        recall = rc if recall is None else {k: recall[k] + v
                                            for k, v in rc.items()}
        preds.append(_host_preds(p))
    return variables, preds, {k: int(v) for k, v in recall.items()}


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize('make_cfg', [tiny_pointpillar_cfg, tiny_second_cfg],
                         ids=['pointpillar', 'second'])
def test_eval_slice_matches_jax(make_cfg):
    cfg = _eval_cfg(make_cfg)
    cfg.MODEL.TEST.NMS_THRESH = 0.5          # many boxes: more to match
    dataset = SyntheticDataset(cfg)
    batches = list(eval_batches(dataset, 2))
    assert [b['batch_size'] for b in batches] == [2, 2, 1]
    variables, jax_preds, jax_recall = _jax_slice(cfg, batches)
    assert jax_recall['gt'] > 0
    jax_ds = _jax_dataset(cfg)
    jax_annos = []
    for batch, p in zip(batches, jax_preds):
        jax_annos += jax_ds.generate_annotations(batch, p, CLASSES)
    want_str, want = jax_ds.evaluation(jax_annos, CLASSES)

    # pcdet_tpu's predictions through the port's recall and evaluator
    thresh = tuple(cfg.MODEL.TEST.RECALL_THRESH_LIST)
    recall, annos = None, []
    for batch, p in zip(batches, jax_preds):
        rc = detector3d.batch_recall(torch.tensor(p['boxes']),
                                     torch.tensor(p['valid']),
                                     torch.tensor(batch['gt_boxes']), thresh)
        recall = rc if recall is None else {k: recall[k] + v
                                            for k, v in rc.items()}
        annos += dataset.generate_annotations(batch, p, CLASSES)
    assert {k: int(v) for k, v in recall.items()} == jax_recall
    got_str, got = dataset.evaluation(annos, CLASSES)
    assert got_str == want_str and got == want

    # the port end to end on the same weights
    det = detect.build_detector(cfg, 'cpu', seed=0)
    det.model.module.load_state_dict(state_dict_from_flax(
        variables, cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']))
    log = logging.getLogger('test_torch_port_eval')
    log.setLevel(logging.INFO)
    log.propagate = False
    handler = _Lines()
    log.addHandler(handler)
    try:
        result = eval_one_epoch(det, iter(batches), dataset, cfg, logger=log)
    finally:
        log.removeHandler(handler)
    assert {k[len('recall/'):]: v for k, v in result.items()
            if k.startswith('recall/')} == jax_recall
    assert want_str in handler.lines
    for k in want:
        assert result[k] == want[k], k
    assert result['overflow/voxelizer'] == 0
    assert result['sec_per_example'] > 0
