"""pcdet_tpu_torch Part-A² training vs pcdet_tpu (CPU, tiny_parta2_cfg).

The same seeded inputs and flax variables (through
`weights.state_dict_from_flax`) go through `pcdet_tpu` and the port:

- the math twins (`huber_loss`, `corner_loss_lidar`,
  `boxes3d_to_corners3d_lidar`, `rotate_points_along_z`, the coder's
  `encode`) to 1e-6 relative; at a zero corner distance torch's norm has
  the gradient 0, JAX's NaN;
- the RoI sampler and target layer on JAX's own picks (1 and 3 classes):
  rois, gt_of_rois_src, roi_raw_scores, roi_labels, roi_valid,
  reg_valid_mask bitwise, the canonical GT to 1e-6, the IoUs and the
  class labels made of them to 1e-5 (the 3-D IoU's bound in
  test_torch_port_eval.py: the two packages clip the quads by different
  routines);
  the picks are rebuilt from JAX's keys (`_jax_picks`, the lines of
  `sample_rois_for_rcnn_single` that draw) and proved by gathering JAX's
  own sampled RoIs;
- the port's own draw, seeded: fg without replacement where bg exists,
  the hard / easy split at HARD_BG_RATIO, an empty fg or bg set;
- `rcnn_loss` and `unet_loss` and their gradients (`jax.vjp`);
- the RoI pool's VJP into the seg (max) and part (avg) features, on
  features without ties (the max scan's tie split differs from JAX's
  `associative_scan` tree where values are equal);
- the inverse conv's VJP against `jax.vjp` of `pcdet_tpu`'s; its backward
  book is the strided conv's forward book;
- one whole train step (DP_RATIO 0, JAX's picks injected): the proposals
  first (RoIs equal in validity and labels, boxes to 1e-5), then the
  sampled targets, the loss and tb to 1e-5, every gradient against the
  port's f64 step beside JAX's f32 ones (see the test: JAX's f32 spreads),
  and the BN running statistics (the RCNN FCs' running mean net of JAX's
  bias: the bias is not in the port, JAX's weight decay moves it).

Also: FCRCNN with dropout takes steps; the dropout and sampler draws come
from the trainer's generator (one seed, one draw; a mask can be given).
The whole-model JAX reference runs once per file.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_config import tiny_parta2_cfg

from pcdet_tpu.datasets.dataset import DatasetTemplate as JaxTemplate
from pcdet_tpu.datasets.synthetic import make_scene
from pcdet_tpu.models import parta2 as jax_parta2
from pcdet_tpu.models import roi_heads as jax_roi
from pcdet_tpu.ops import host_books as jax_books
from pcdet_tpu.ops import roiaware_pool as jax_pool
from pcdet_tpu.ops import rotated_iou as jax_iou
from pcdet_tpu.ops import sparse as jax_sparse
from pcdet_tpu.ops.voxelizer import voxelize_jnp
from pcdet_tpu.utils import jnp_common, loss as jax_loss
from pcdet_tpu.utils.box_coder import ResidualCoder as JaxCoder
from pcdet_tpu_torch.models import parta2, roi_heads
from pcdet_tpu_torch.ops import roiaware_pool, sparse
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.train import train_state
from pcdet_tpu_torch.train.trainer import build_trainer
from pcdet_tpu_torch.utils import box_np_ops, loss as port_loss, torch_common
from pcdet_tpu_torch.utils.box_coder import ResidualCoder
from pcdet_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

KEY = 3              # the JAX train step's rng seed
IOU_TOL = 1e-5


def _close(got, want, tol, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(scale, 1e-30),
                               err_msg=what)


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-10, 10, (n, 2))
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


# ------------------------------------------------------------ math twins ---

def test_math_twins_match_jax():
    rng = np.random.RandomState(0)
    pred, gt = _boxes(rng, 64), _boxes(rng, 64)
    pts = rng.randn(5, 7, 4).astype(np.float32)
    ang = rng.uniform(-3, 3, 5).astype(np.float32)
    err = rng.randn(100).astype(np.float32) * 2
    t = torch.as_tensor
    _close(torch_common.boxes3d_to_corners3d_lidar(t(pred)).numpy(),
           jnp_common.boxes3d_to_corners3d_lidar(jnp.asarray(pred)), 1e-6)
    _close(torch_common.boxes3d_to_corners3d_lidar(
        t(pred), bottom_center=False).numpy(),
        jnp_common.boxes3d_to_corners3d_lidar(jnp.asarray(pred), False),
        1e-6)
    _close(torch_common.rotate_points_along_z(t(pts), t(ang)).numpy(),
           jnp_common.rotate_points_along_z(jnp.asarray(pts),
                                            jnp.asarray(ang)), 1e-6)
    _close(port_loss.huber_loss(t(err), 1.0).numpy(),
           jax_loss.huber_loss(jnp.asarray(err), 1.0), 1e-6)
    _close(port_loss.corner_loss_lidar(t(pred), t(gt)).numpy(),
           jax_loss.corner_loss_lidar(jnp.asarray(pred), jnp.asarray(gt)),
           1e-6)
    anchors = _boxes(rng, 64)
    _close(ResidualCoder.encode(t(gt), t(anchors)).numpy(),
           JaxCoder.encode_jnp(jnp.asarray(gt), jnp.asarray(anchors)), 1e-6)


def test_corner_loss_gradient_at_a_zero_distance():
    """Away from zero the gradients agree; where a predicted corner lies on
    the GT's, torch's norm gives 0 and JAX's NaN."""
    rng = np.random.RandomState(1)
    pred, gt = _boxes(rng, 16), _boxes(rng, 16)
    p = torch.as_tensor(pred).requires_grad_()
    port_loss.corner_loss_lidar(p, torch.as_tensor(gt)).sum().backward()
    want = jax.grad(lambda q: jax_loss.corner_loss_lidar(
        q, jnp.asarray(gt)).sum())(jnp.asarray(pred))
    _close(p.grad.numpy(), want, 1e-5)
    p = torch.as_tensor(gt).requires_grad_()
    port_loss.corner_loss_lidar(p, torch.as_tensor(gt)).sum().backward()
    assert torch.isfinite(p.grad).all() and not p.grad.any()
    want = jax.grad(lambda q: jax_loss.corner_loss_lidar(
        q, jnp.asarray(gt)).sum())(jnp.asarray(gt))
    assert np.isnan(np.asarray(want)).any()


# ---------------------------------------------------------- RoI sampler ---

def _sampler_cfg(roi_per_image=32):
    sc = copy.deepcopy(tiny_parta2_cfg().MODEL.RCNN.TARGET_CONFIG)
    sc.ROI_PER_IMAGE = roi_per_image
    return sc


def _jax_picks(rng, roi_dict, gt_boxes, sc, num_class):
    """JAX's sampled proposal indices (B, R): the draws of
    `pcdet_tpu.models.roi_heads.sample_rois_for_rcnn_single` under its
    keys, per sample as `proposal_target_layer` splits them."""
    r = int(sc.ROI_PER_IMAGE)
    fg_per_image = int(np.round(sc.FG_RATIO * r))
    reg_fg, cls_bg_lo = float(sc.REG_FG_THRESH), float(sc.CLS_BG_THRESH_LO)
    keys = jax.random.split(rng, roi_dict['rois'].shape[0])
    out = []
    for b, k in enumerate(keys):
        rois, labels = roi_dict['rois'][b], roi_dict['roi_labels'][b]
        valid, gt = roi_dict['roi_valid'][b], gt_boxes[b]
        gt_valid = jnp.abs(gt[:, :7]).sum(axis=1) > 0
        iou = jax_iou.boxes_iou3d(rois, gt[:, :7])
        if num_class > 1:
            iou = jnp.where(labels[:, None] == gt[None, :, 7].astype(
                jnp.int32), iou, 0.0)
        iou = jnp.where(gt_valid[None, :] & valid[:, None], iou, 0.0)
        mo = jnp.max(iou, axis=1)
        fg = (mo >= min(reg_fg, float(sc.CLS_FG_THRESH))) & valid
        easy = (mo < cls_bg_lo) & valid
        hard = (mo < reg_fg) & (mo >= cls_bg_lo) & valid
        n_fg, n_easy, n_hard = fg.sum(), easy.sum(), hard.sum()
        n_bg = n_easy + n_hard
        k_fg, _, k_hard, k_easy, k_fgr = jax.random.split(k, 5)
        fg_count = jnp.where(n_bg > 0, jnp.minimum(fg_per_image, n_fg), r)
        fg_count = jnp.where(n_fg > 0, fg_count, 0)
        fg_pick = jnp.where(n_bg > 0,
                            jax_roi._masked_choice(k_fg, fg, r, False),
                            jax_roi._masked_choice(k_fgr, fg, r, True))
        slots = jnp.arange(r)
        bg_count = r - fg_count
        hard_num = jnp.where((n_hard > 0) & (n_easy > 0),
                             (bg_count.astype(jnp.float32) * float(
                                 sc.HARD_BG_RATIO)).astype(jnp.int32),
                             jnp.where(n_hard > 0, bg_count, 0))
        bg_pick = jnp.where(slots - fg_count < hard_num,
                            jax_roi._masked_choice(k_hard, hard, r, True),
                            jax_roi._masked_choice(k_easy, easy, r, True))
        out.append(np.asarray(jnp.where(slots < fg_count, fg_pick, bg_pick)))
    return np.stack(out).astype(np.int64)


def _proposals(seed, num_class, b=2, m=64, g=8):
    """Proposals around GT boxes (near copies, shifted and resized ones,
    random ones), some invalid and zeroed, and zero-padded GT."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, g, 8), np.float32)
    rois = np.zeros((b, m, 7), np.float32)
    for i in range(b):
        n = g - 2 - i
        gt[i, :n, :7] = _boxes(rng, n)
        gt[i, :n, 7] = rng.randint(1, num_class + 1, n)
        src = gt[i, rng.randint(0, n, m), :7].copy()
        jitter = rng.choice([0.0, 0.15, 0.6, 3.0], m)[:, None]
        src[:, 0:3] += rng.randn(m, 3) * jitter
        src[:, 3:6] *= np.exp(rng.randn(m, 3) * jitter * 0.3)
        src[:, 6] += rng.randn(m) * jitter[:, 0]
        rois[i] = src
    valid = rng.rand(b, m) > 0.1
    rois *= valid[..., None]
    return {'rois': rois, 'roi_raw_scores': rng.randn(b, m).astype(
        np.float32), 'roi_labels': rng.randint(1, num_class + 1, (b, m))
        .astype(np.int32), 'roi_valid': valid}, gt


@pytest.mark.parametrize('num_class', [1, 3])
@pytest.mark.parametrize('score_type', ['roi_iou', 'cls'])
def test_target_layer_on_jax_picks_matches_jax(num_class, score_type):
    roi_np, gt = _proposals(num_class, num_class)
    sc = _sampler_cfg()
    sc.CLS_SCORE_TYPE = score_type
    key = jax.random.PRNGKey(num_class)
    roi_j = {k: jnp.asarray(v) for k, v in roi_np.items()}
    want = jax_roi.proposal_target_layer(key, roi_j, jnp.asarray(gt), sc,
                                         num_class)
    picks = _jax_picks(key, roi_j, jnp.asarray(gt), sc, num_class)
    # the rebuilt picks are JAX's: they gather its sampled RoIs
    np.testing.assert_array_equal(
        np.take_along_axis(roi_np['rois'], picks[..., None], 1),
        np.asarray(want['rois']))
    got = roi_heads.proposal_target_layer(
        {k: torch.as_tensor(v) for k, v in roi_np.items()},
        torch.as_tensor(gt), sc, num_class, picks=torch.as_tensor(picks))
    for k in ('rois', 'gt_of_rois_src', 'roi_raw_scores', 'roi_labels',
              'roi_valid', 'reg_valid_mask'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ('gt_iou', 'rcnn_cls_labels'):
        _close(got[k].numpy(), want[k], IOU_TOL, k)
    _close(got['gt_of_rois'].numpy(), want['gt_of_rois'], 1e-6)
    assert got['reg_valid_mask'].any() and (~got['reg_valid_mask']
                                            .bool()).any()
    s = got['sampler']
    assert (s['n_fg'] > 0).all() and (s['n_hard'] > 0).all()
    assert (s['fg_count'] <= 16).all()


def test_masked_choice_draws():
    """Without replacement: distinct True indices first; with replacement:
    True indices only, each about equally often; an empty row gives 0."""
    gen = torch.Generator().manual_seed(0)
    mask = torch.zeros(3, 50, dtype=torch.bool)
    mask[0, ::3] = True
    mask[1, 7] = True
    perm = roi_heads.masked_choice(mask, 50, False, gen)
    for row, n in ((0, 17), (1, 1), (2, 0)):
        first = perm[row, :n]
        assert len(set(first.tolist())) == n
        assert mask[row, first].all()
        assert not mask[row, perm[row, n:]].any()
    draws = roi_heads.masked_choice(mask, 20000, True, gen)
    assert mask[0, draws[0]].all() and (draws[1] == 7).all()
    assert (draws[2] == 0).all()
    counts = torch.bincount(draws[0], minlength=50)[::3].double()
    assert abs(counts.mean() - 20000 / 17) < 1e-9
    assert (counts - 20000 / 17).abs().max() < 5 * (20000 / 17) ** 0.5


def test_sampler_draw_split_and_empty_sets():
    """The port's own draw on a seeded generator: fg picks distinct where
    bg exists, hard_num hard picks then easy ones, all fg (with
    replacement) where no bg exists, all bg where no fg exists, invalid
    where neither exists; one seed, one draw."""
    roi_np, gt = _proposals(5, 1)
    sc = _sampler_cfg()
    t = {k: torch.as_tensor(v) for k, v in roi_np.items()}
    gen = torch.Generator().manual_seed(0)
    out = roi_heads.sample_rois(t['rois'], t['roi_raw_scores'],
                                t['roi_labels'], t['roi_valid'],
                                torch.as_tensor(gt), sc, 1, gen)
    again = roi_heads.sample_rois(
        t['rois'], t['roi_raw_scores'], t['roi_labels'], t['roi_valid'],
        torch.as_tensor(gt), sc, 1, torch.Generator().manual_seed(0))
    assert torch.equal(out['picks'], again['picks'])
    iou = np.asarray(out['roi_iou'])
    for b in range(2):
        fc, hn = int(out['fg_count'][b]), int(out['hard_num'][b])
        n_fg = int(out['n_fg'][b])
        assert fc == min(16, n_fg) and hn == int((32 - fc) * 0.8)
        assert len(set(out['picks'][b, :fc].tolist())) == fc
        assert (iou[b, :fc] >= 0.55).all()
        assert ((iou[b, fc:fc + hn] >= 0.1) & (iou[b, fc:fc + hn] < 0.55)).all()
        assert (iou[b, fc + hn:] < 0.1).all()
    # no GT: no fg, every slot bg
    none = roi_heads.sample_rois(t['rois'], t['roi_raw_scores'],
                                 t['roi_labels'], t['roi_valid'],
                                 torch.zeros_like(torch.as_tensor(gt)), sc, 1,
                                 gen)
    assert (none['fg_count'] == 0).all() and (none['hard_num'] == 0).all()
    assert none['valid'].all() and (none['roi_iou'] == 0).all()
    # every proposal a GT copy: no bg, every slot fg with replacement
    g = torch.as_tensor(gt)
    same = g[:, :4, :7].repeat(1, 16, 1)
    allfg = roi_heads.sample_rois(same, t['roi_raw_scores'], t['roi_labels'],
                                  torch.ones(2, 64, dtype=torch.bool), g, sc,
                                  1, gen)
    assert (allfg['fg_count'] == 32).all() and (allfg['roi_iou'] > 0.99).all()
    # no valid proposal: the sample is invalid
    empty = roi_heads.sample_rois(t['rois'], t['roi_raw_scores'],
                                  t['roi_labels'],
                                  torch.zeros(2, 64, dtype=torch.bool), g, sc,
                                  1, gen)
    assert not empty['valid'].any()


# --------------------------------------------------------------- losses ---

def _rcnn_inputs(seed=0):
    roi_np, gt = _proposals(seed, 1)
    sc = _sampler_cfg()
    key = jax.random.PRNGKey(seed)
    tgt = jax_roi.proposal_target_layer(
        key, {k: jnp.asarray(v) for k, v in roi_np.items()}, jnp.asarray(gt),
        sc, 1)
    rng = np.random.RandomState(seed)
    n = tgt['rois'].shape[:2]
    ret = {k: np.asarray(v) for k, v in tgt.items()}
    ret['rcnn_cls'] = rng.randn(*n).astype(np.float32)
    ret['rcnn_reg'] = (rng.randn(*n, 7) * 0.3).astype(np.float32)
    return ret


LOSS_WEIGHTS = {'rcnn_cls_weight': 1.0, 'rcnn_reg_weight': 1.5,
                'rcnn_corner_weight': 0.7,
                'code_weights': [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0]}


def test_rcnn_loss_and_gradient_match_jax():
    ret = {k: v.copy() for k, v in _rcnn_inputs().items()}
    assert ret['reg_valid_mask'].any() and not ret['reg_valid_mask'].all()
    # a zero-size padded RoI among the non-fg rows
    ret['rois'][0, -1] = 0

    def jax_fn(cls, reg):
        return jax_roi.rcnn_loss(dict({k: jnp.asarray(v) for k, v in
                                       ret.items()}, rcnn_cls=cls,
                                      rcnn_reg=reg), LOSS_WEIGHTS)

    (loss, tb), vjp = jax.vjp(jax_fn, jnp.asarray(ret['rcnn_cls']),
                              jnp.asarray(ret['rcnn_reg']))
    g_cls, g_reg = vjp((jnp.float32(1.0), {k: jnp.zeros(()) for k in tb}))
    t = {k: torch.as_tensor(v) for k, v in ret.items()}
    t['rcnn_cls'].requires_grad_()
    t['rcnn_reg'].requires_grad_()
    got, got_tb = roi_heads.rcnn_loss(t, LOSS_WEIGHTS)
    got.backward()
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-6)
    assert sorted(got_tb) == sorted(tb)
    for k in tb:
        np.testing.assert_allclose(float(got_tb[k]), float(tb[k]), rtol=1e-6,
                                   err_msg=k)
    assert float(tb['rcnn_loss_corner']) > 0
    _close(t['rcnn_cls'].grad.numpy(), g_cls, 1e-6)
    _close(t['rcnn_reg'].grad.numpy(), g_reg, 1e-6)
    assert torch.isfinite(t['rcnn_reg'].grad).all()


def test_unet_loss_and_gradient_match_jax():
    rng = np.random.RandomState(2)
    seg = rng.randn(2, 300, 1).astype(np.float32)
    reg = rng.randn(2, 300, 3).astype(np.float32)
    labels = rng.choice([-1, 0, 0, 0, 1, 2], (2, 300)).astype(np.int32)
    parts = rng.rand(2, 300, 3).astype(np.float32)
    (loss, tb), vjp = jax.vjp(
        lambda s, r: jax_parta2.unet_loss(s, r, jnp.asarray(labels),
                                          jnp.asarray(parts)),
        jnp.asarray(seg), jnp.asarray(reg))
    g_seg, g_reg = vjp((jnp.float32(1.0), {k: jnp.zeros(()) for k in tb}))
    ts = torch.as_tensor(seg).requires_grad_()
    tr = torch.as_tensor(reg).requires_grad_()
    got, got_tb = parta2.unet_loss(ts, tr, torch.as_tensor(labels),
                                   torch.as_tensor(parts))
    got.backward()
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-6)
    for k in tb:
        np.testing.assert_allclose(float(got_tb[k]), float(tb[k]), rtol=1e-6,
                                   err_msg=k)
    _close(ts.grad.numpy(), g_seg, 1e-6)
    _close(tr.grad.numpy(), g_reg, 1e-6)


# ------------------------------------------------------- RoI pool's VJP ---

def test_roi_pool_vjp_matches_jax():
    """Random features (no ties among a cell's values) and random output
    cotangents: the VJP into the max-pooled seg features and the averaged
    part features to 1e-6 of max."""
    rng = np.random.RandomState(4)
    b, n, o = 2, 5, 6
    rois = np.zeros((b, n, 7), np.float32)
    rois[..., 0:2] = rng.uniform(-4, 4, (b, n, 2))
    rois[..., 2] = -1
    rois[..., 3:6] = rng.uniform(2, 4, (b, n, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    pts = np.concatenate([rng.uniform(-6, 6, (b, 600, 2)),
                          rng.uniform(-1, 2.5, (b, 600, 1))], -1).astype(
                              np.float32)
    mask = rng.rand(b, 600) > 0.05
    seg = rng.randn(b, 600, 5).astype(np.float32)
    part = rng.rand(b, 600, 4).astype(np.float32)
    cot_avg = rng.randn(b, n, o, o, o, 4).astype(np.float32)
    cot_max = rng.randn(b, n, o, o, o, 5).astype(np.float32)

    def jfn(fa, fm):
        return jax_pool.roiaware_pool3d_multi_batched(
            jnp.asarray(rois), jnp.asarray(pts), [(fa, 'avg'), (fm, 'max')],
            jnp.asarray(mask), out_size=o, max_pts_per_roi=128)

    outs, vjp = jax.vjp(jfn, jnp.asarray(part), jnp.asarray(seg))
    want_a, want_m = vjp([jnp.asarray(cot_avg), jnp.asarray(cot_max)])
    fa = torch.as_tensor(part).requires_grad_()
    fm = torch.as_tensor(seg).requires_grad_()
    got = roiaware_pool.roiaware_pool3d_multi_batched(
        torch.as_tensor(rois), torch.as_tensor(pts), [(fa, 'avg'), (fm, 'max')],
        torch.as_tensor(mask), out_size=o, max_pts_per_roi=128)
    torch.autograd.backward(got, [torch.as_tensor(cot_avg),
                                  torch.as_tensor(cot_max)])
    assert np.abs(np.asarray(want_m)).max() > 0
    _close(fa.grad.numpy(), want_a, 1e-6, 'avg')
    _close(fm.grad.numpy(), want_m, 1e-6, 'max')


# ----------------------------------------------------- whole train step ---

def _scans(cfg):
    rng = np.random.RandomState(0)
    p = int(cfg.DATA_CONFIG.MAX_POINTS)
    g = int(cfg.DATA_CONFIG.MAX_GT_BOXES)
    points = np.zeros((2, p, 4), np.float32)
    mask = np.zeros((2, p), bool)
    gt = np.zeros((2, g, 8), np.float32)
    for i in range(2):
        pts, boxes, _ = make_scene(rng, ['Car'], num_objects=5,
                                   x_range=(3, 30), y_range=(-14, 14))
        n = min(len(pts), p)
        points[i, :n], mask[i, :n] = pts[:n], True
        gt[i, :len(boxes), :7] = boxes
        gt[i, :len(boxes), 7] = 1
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
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=4)
    trainer.model.module.load_state_dict(state_dict_from_flax(
        variables, cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums'], cfg.MODEL.RCNN))
    return trainer


def _with_proposal_gt(cfg, variables, points, mask, gt):
    """The scene's GT plus, per sample, three of stage 1's proposals that
    hold the most voxels (class 1), each moved by 0.1 m and grown by 5%,
    so that the sampler finds fg RoIs (an exact copy's IoU of 1, its
    coincident edges, is where the two packages' clipping routines differ
    most)."""
    trainer = _trainer(cfg, variables)
    batch = trainer.make_batch(torch.as_tensor(points), torch.as_tensor(mask),
                               gt)
    with torch.no_grad():
        ret = trainer.model.forward(batch)
    roi = ret['rcnn']
    centers = trainer.model.voxel_centers(batch['coordinates']).numpy()
    live = batch['voxel_mask'].numpy()
    gt = gt.copy()
    for b in range(2):
        boxes = roi['rois'][b].numpy()
        ok = roi['roi_valid'][b].numpy() & (boxes[:, 3:6].max(1) < 8)
        inside = box_np_ops.points_in_boxes_mask(centers[b][live[b]],
                                                 boxes).sum(1)
        order = np.argsort(-np.where(ok, inside, -1), kind='stable')[:3]
        n = int((np.abs(gt[b, :, :7]).sum(1) > 0).sum())
        gt[b, n:n + 3, :7] = boxes[order] * [1, 1, 1, 1.05, 1.05, 1.05, 1]
        gt[b, n:n + 3, 0] += 0.1
        gt[b, n:n + 3, 7] = 1
    return gt


def _jax_proposals(jmodel, cfg, heads):
    """JAX's proposal layer at TRAIN's sizes on its stage-1 head outputs."""
    b, a = heads['box_preds'].shape[0], jmodel.anchors.shape[0]
    tc = cfg.MODEL.TRAIN
    return jax_roi.proposal_layer_from_head(
        heads['cls_preds'].reshape(b, a, -1),
        heads['box_preds'].reshape(b, a, -1),
        jmodel.anchors.astype(heads['box_preds'].dtype),
        heads['dir_cls_preds'].reshape(b, a, -1), jmodel.box_coder,
        jmodel.head_args, nms_pre=int(tc.NMS_PRE_MAXSIZE),
        nms_post=int(tc.NMS_POST_MAXSIZE),
        nms_thresh=float(tc.RPN_NMS_THRESH))


@pytest.fixture(scope='module')
def step():
    cfg = tiny_parta2_cfg(num_class=1)
    cfg.MODEL.RCNN.DP_RATIO = 0.0
    points, mask, gt = _scans(cfg)
    dc = cfg.DATA_CONFIG
    vs, pr = tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE), tuple(dc.POINT_CLOUD_RANGE)
    cap = int(dc.TRAIN.MAX_NUMBER_OF_VOXELS)
    jmodel = jax_parta2.PartA2Net(cfg, grid_size(vs, pr))
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
    gt = _with_proposal_gt(cfg, variables, points, mask, gt)

    trainer = _trainer(cfg, variables)
    batch = trainer.make_batch(torch.as_tensor(points), torch.as_tensor(mask),
                               gt)
    flat = jax_books.build_books_batch(
        np.asarray(vox['coordinates']), np.asarray(vox['voxel_mask']),
        jmodel.sparse_shape, jmodel.host_book_spec(cap, True))
    jbatch.update({k: jnp.asarray(v) for k, v in flat.items()})
    targets = [jmodel.anchor_targets.assign(g) for g in gt]
    jbatch['box_cls_labels'] = jnp.asarray(np.stack(
        [t['labels'] for t in targets]).astype(np.int32))
    jbatch['box_reg_targets'] = jnp.asarray(np.stack(
        [t['bbox_targets'] for t in targets]).astype(np.float32))
    seg, part = [], []
    coords = np.asarray(vox['coordinates'])
    for b in range(2):
        c = coords[b]
        centers = ((c[:, ::-1].astype(np.float32) + 0.5) * np.asarray(vs)
                   + np.asarray(pr[:3])).astype(np.float32)
        g = gt[b][np.abs(gt[b, :, :7]).sum(1) > 0]
        s, p = JaxTemplate.generate_voxel_part_targets(
            None, centers, np.asarray(vox['voxel_mask'][b]), g[:, :7],
            g[:, 7].astype(np.int32), cfg.MODEL.RPN.BACKBONE.TARGET_CONFIG)
        seg.append(s)
        part.append(p)
    jbatch['seg_labels'] = jnp.asarray(np.stack(seg))
    jbatch['part_labels'] = jnp.asarray(np.stack(part))
    jbatch['gt_boxes'] = jnp.asarray(gt)
    jbatch['voxel_overflow'] = jnp.asarray(batch['voxel_overflow'].numpy())
    key = jax.random.PRNGKey(KEY)

    def loss_fn(params):
        ret, stats = jmodel.forward(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jbatch, train=True, rng=key)
        loss, tb = jmodel.loss(ret, jbatch)
        heads = {k: ret[k] for k in ('cls_preds', 'box_preds',
                                     'dir_cls_preds')}
        return loss, (stats, tb, heads, ret['rcnn'])

    (loss, (stats, tb, heads, jrcnn)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'])
    roi_j = _jax_proposals(jmodel, cfg, heads)
    picks = _jax_picks(jax.random.fold_in(key, 7), roi_j, jbatch['gt_boxes'],
                       cfg.MODEL.RCNN.TARGET_CONFIG, 1)

    model = trainer.model
    model.fixed_picks = torch.as_tensor(picks)
    model.train_mode()
    ret = model.forward(batch)
    got_loss, got_tb = model.loss(ret, batch)
    got_grads = torch.autograd.grad(got_loss, trainer.state.params)
    with torch.no_grad():
        roi_p = model.proposals(ret, train=True)
    return {'cfg': cfg, 'jmodel': jmodel, 'variables': variables,
            'trainer': trainer,
            'batch': batch, 'jbatch': jbatch, 'gt': gt, 'picks': picks,
            'roi_j': roi_j, 'roi_p': roi_p, 'jrcnn': jrcnn, 'ret': ret,
            'want': (loss, stats, tb, grads),
            'got': (got_loss.detach(), {k: v.detach() for k, v in
                                        got_tb.items()}, got_grads)}


def test_batch_targets_match_the_jax_loader(step):
    b, jb = step['batch'], step['jbatch']
    for k in ('coordinates', 'box_cls_labels', 'box_reg_targets',
              'seg_labels', 'part_labels', 'gt_boxes'):
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)
    assert (b['seg_labels'].numpy() > 0).sum(1).min() > 0


def test_proposals_match_jax(step):
    """The same RoI set before any gradient is compared."""
    p, j = step['roi_p'], step['roi_j']
    np.testing.assert_array_equal(p['roi_valid'].numpy(),
                                  np.asarray(j['roi_valid']))
    np.testing.assert_array_equal(p['roi_labels'].numpy(),
                                  np.asarray(j['roi_labels']))
    _close(p['rois'].numpy(), j['rois'], 1e-5, 'rois')
    _close(p['roi_raw_scores'].numpy(), j['roi_raw_scores'], 1e-5)


def test_sampled_targets_match_jax(step):
    got, want = step['ret']['rcnn'], step['jrcnn']
    # the rebuilt picks gather JAX's sampled RoIs (its proposals, decoded
    # eagerly here and inside its jit there, agree to rounding)
    _close(np.take_along_axis(np.asarray(step['roi_j']['rois']),
                              step['picks'][..., None], 1),
           want['rois'], 1e-6)
    for k in ('roi_valid', 'roi_labels', 'reg_valid_mask', 'gt_of_rois_src'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ('rois', 'gt_iou', 'rcnn_cls_labels', 'gt_of_rois', 'rcnn_cls',
              'rcnn_reg'):
        _close(got[k].detach().numpy(), want[k], 1e-4, k)
    assert got['reg_valid_mask'].sum() >= 2


def test_loss_and_tb_match_jax(step):
    loss, _, tb, _ = step['want']
    got_loss, got_tb, _ = step['got']
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    assert sorted(got_tb) == sorted(tb)
    assert 'overflow/roi_pts' in tb and float(tb['rcnn_loss_reg']) > 0
    for k, v in tb.items():
        np.testing.assert_allclose(float(got_tb[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def _proposals64(roi, xp):
    """A proposal dict with its float arrays in f64 (`xp`: jnp or torch)."""
    out = {}
    for k, v in roi.items():
        v = np.asarray(v)
        out[k] = xp.asarray(v.astype(np.float64) if v.dtype == np.float32
                            else v)
    return out


def test_every_gradient_matches_jax(step):
    """Against the port's step in f64 (the f32 run's proposals and picks):
    per leaf, relative to its largest f64 value, the port's f32 gradient
    lies within 1e-4 of it or, where JAX's own f32 gradient lies farther,
    within twice JAX's distance; JAX's f32 gradients lie within 1e-2 of
    it.  JAX's f32 reductions spread here, as PR 12 found for PointPillar:
    its f32 gradients lie up to 2e-3 of max from the f64 answer (the
    decoder's deepest level, inv_conv4), the port's within 1e-5 but at the
    ill-conditioned BN biases of conv2.0 and conv3.0 (sums of many
    cancelling terms), where both f32 results lie 4e-4 and 6e-3 from it.  (A JAX run in f64 is not the referee: its NMS loop is
    not x64-clean, and an x64 run of the whole tiny step takes over ten
    minutes on this CPU.)"""
    cfg = step['cfg']
    module = step['trainer'].model.module
    names = [n for n, _ in module.named_parameters()]
    layer_nums = cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']
    jax32 = state_dict_from_flax({'params': step['want'][3]}, layer_nums,
                                 cfg.MODEL.RCNN)
    assert sorted(jax32) == sorted(names)
    trainer64 = _trainer(cfg, step['variables'])
    model = trainer64.model
    model.module.double()
    for attr in ('anchors', 'voxel_size', 'pc_origin'):
        setattr(model, attr, getattr(model, attr).double())
    model.fixed_picks = torch.as_tensor(step['picks'])
    model.proposals = lambda ret, train=False: _proposals64(step['roi_p'],
                                                           torch)
    batch64 = {k: v.double() if torch.is_tensor(v) and v.dtype ==
               torch.float32 else v for k, v in step['batch'].items()}
    loss64, _, port64 = train_state.loss_and_grads(
        model, trainer64.state.params, batch64)
    np.testing.assert_allclose(float(loss64), float(step['got'][0]),
                               rtol=1e-5)
    for name, g, g64 in zip(names, step['got'][2], port64):
        ref, j32 = g64.numpy(), jax32[name].numpy().astype(np.float64)
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        err = float(np.abs(g.numpy() - ref).max()) / scale
        jax_err = float(np.abs(j32 - ref).max()) / scale
        assert err <= max(1e-4, 2 * jax_err), (name, err, jax_err)
        assert jax_err <= 1e-2, (name, jax_err)


def test_bn_running_statistics_match_jax(step):
    """Every BN's running mean and variance; the RCNN FCs' running mean is
    compared net of JAX's bias (the conversion's, old params)."""
    cfg = step['cfg']
    want = state_dict_from_flax(
        {'params': step['variables']['params'],
         'batch_stats': step['want'][1]},
        cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums'], cfg.MODEL.RCNN)
    got = step['trainer'].model.module.state_dict()
    keys = [k for k in want if k.endswith(('running_mean', 'running_var'))]
    assert any(k.startswith('rcnn_net.shared_fc') for k in keys)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


# ------------------------------------------------- inverse conv's VJP ---

def test_inverse_conv_vjp_matches_jax(step):
    """inv_conv2's geometry on the train batch's books: the VJP into the
    coarse features and the weights against `jax.vjp`, 1e-5 of max; the
    backward book (the strided conv's forward book) equals the transpose
    of the inverse conv's own."""
    batch, jbatch = step['batch'], step['jbatch']
    model = step['trainer'].model
    shape = model.sparse_shape
    books = batch['books']
    rng = np.random.RandomState(8)
    m = batch['voxel_mask'].numpy()
    f = rng.randn(*m.shape, 16).astype(np.float32) * m[..., None]
    w = rng.uniform(-0.2, 0.2, (27, 16, 16)).astype(np.float32)
    fine_j = jax_sparse.from_voxelizer(jnp.asarray(f), jbatch['coordinates'],
                                       jbatch['voxel_mask'], shape)
    coarse_j = jax_sparse.sparse_conv3d_batched(
        fine_j, jnp.asarray(w), 3, 2, 1, indice_key='spconv2',
        book=jax_books.unpack_books(jbatch)['spconv2'])
    fine_p = sparse.from_voxelizer(torch.as_tensor(f), batch['coordinates'],
                                   batch['voxel_mask'], shape)
    coarse_p = sparse.sparse_conv3d(fine_p, torch.as_tensor(w),
                                    books['spconv2'], 3, 2, 1,
                                    loads=sparse.ROWS)
    cm = coarse_p.mask.numpy()
    x = (rng.randn(*cm.shape, 16).astype(np.float32) * cm[..., None])
    w2 = rng.uniform(-0.2, 0.2, (27, 16, 16)).astype(np.float32)
    cot = rng.randn(*m.shape, 16).astype(np.float32) * m[..., None]

    def jfn(xx, ww):
        return jax_sparse.inverse_conv3d_batched(
            coarse_j._replace(features=xx), fine_j, ww, 3, 2, 1,
            indice_key='spconv2').features

    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w2))
    want_x, want_w = vjp(jnp.asarray(cot))
    rules = books['spconv2'][4]
    rules_t = sparse.inverse_rules(rules, fine_p.mask)
    n_coarse = rules.shape[1]
    assert torch.equal(sparse.transpose_rules(rules_t, n_coarse,
                                              m.shape[1]), rules)
    for loads in (sparse.ROWS, sparse.Loads('xwin', 'xwin'),
                  sparse.Loads('seg', 'seg')):
        tx = torch.as_tensor(x).requires_grad_()
        tw = torch.as_tensor(w2).requires_grad_()
        out = sparse.inverse_conv3d(coarse_p._replace(features=tx), fine_p,
                                    tw, books['spconv2'], 3, 2, 1,
                                    loads=loads)
        out.features.backward(torch.as_tensor(cot))
        _close(tx.grad.numpy(), want_x, 1e-5, str(loads))
        _close(tw.grad.numpy(), want_w, 1e-5, str(loads))


# ------------------------------------------------------------ the heads ---

def _fc_cfg(dp):
    cfg = tiny_parta2_cfg(num_class=1)
    rc = cfg.MODEL.RCNN
    rc.NAME, rc.ROI_AWARE_POOL_SIZE = 'FCRCNN', 12
    rc.SHARED_FC, rc.DP_RATIO = [32, 64, 64], dp
    return cfg


def test_fcrcnn_with_dropout_takes_steps_from_its_generator(step):
    """FCRCNN (12³, dropout 0.3) trains on the step's batch: finite losses;
    two trainers of one seed draw the same sampler picks and dropout masks
    and give the same bits; a given mask replaces the draw."""
    cfg = _fc_cfg(0.3)
    points_batch = step['batch']
    runs = []
    for _ in range(2):
        trainer = build_trainer(cfg, 'cpu', seed=5, total_steps=4)
        tbs = [trainer.step(points_batch)]
        drops = trainer.model.dropouts()
        assert len(drops) == 3 and all(d.last_mask is not None for d in drops)
        runs.append((tbs, [d.last_mask for d in drops],
                     trainer.model.last_sampler['picks']))
        tbs.append(trainer.step(points_batch))
    for tb in runs[0][0]:
        assert all(torch.isfinite(v).all() for v in tb.values())
    assert float(runs[0][0][1]['loss']) != float(runs[0][0][0]['loss'])
    for a, b in zip(runs[0][0], runs[1][0]):
        assert float(a['loss']) == float(b['loss'])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b) and 0.6 < a.float().mean() < 0.8
    assert torch.equal(runs[0][2], runs[1][2])
    trainer = build_trainer(cfg, 'cpu', seed=6, total_steps=4)
    for d, mask in zip(trainer.model.dropouts(), runs[0][1]):
        d.fixed_mask = mask
    trainer.model.fixed_picks = runs[0][2]
    other = build_trainer(cfg, 'cpu', seed=5, total_steps=4)
    trainer.model.module.load_state_dict(other.model.module.state_dict())
    one = other.step(points_batch)
    two = trainer.step(points_batch)
    assert float(one['loss']) == float(two['loss'])
    assert torch.equal(trainer.model.dropouts()[0].last_mask, runs[0][1][0])
