"""Kernel F (`ops/nms_fused.py`, `csrc/nms_fused.cu`): exact greedy NMS in
one launch a call, against the eager loop it replaces on the card.

On the CPU (tier 1): the launch plan for each configuration's (G, pre)
within an H100's shared memory and cluster size; the kernel's wrapper
refusing what it does not take; CPU tensors still going through the eager
loop (`nms._lazy_greedy_batched`) with the sequential greedy's results;
`boxes5_to_corners` making its sign constants on the boxes' device with the
same bits.

On the card (marked `gpu`; they skip without one; this file imports only
torch and the port):

    python -m pytest --noconftest -m gpu tests/test_torch_port_nms_fused.py

F's `selected` and `num` equal, bit for bit, the eager loop's (kernel A
with the rounds on the host) and a one-box-at-a-time greedy's on CPU copies
(`_sequential`), rotated and axis-aligned, at PointPillar's and SECOND's
shapes, Part-A²'s proposal and test NMS, G 1, 2 and 8, pre under 64 and not
a multiple of 64, post_max reached inside a block, every box invalid and
every box kept, tied scores, duplicate boxes and an IoU exactly at the
threshold; each group's device round count equals the eager loop's rounds
on that group alone; one launch a call, counted in `nms_fused.LAUNCHES` and
in `rotated_overlap.LAUNCHES`; no host sync (torch.cuda's sync debug mode
'error'); per-class NMS through F equal to it through the eager loop and
through the sequential greedy; the Python mirror of the kernel's shared
memory equal to the kernel's.
"""
import numpy as np
import pytest
import torch

from pcdet_tpu_torch.models import detector3d
from pcdet_tpu_torch.ops import nms, nms_fused, rotated_iou, rotated_overlap

torch.set_num_threads(1)

H100_SMEM_PER_SM = 228 * 1024


def _boxes5(rng, g, n, spread, size=(1.0, 5.0)):
    cx = rng.uniform(-spread, spread, (g, n))
    cy = rng.uniform(-spread, spread, (g, n))
    w = rng.uniform(*size, (g, n))
    ln = rng.uniform(*size, (g, n))
    ang = rng.uniform(-np.pi, np.pi, (g, n))
    return torch.as_tensor(np.stack(
        [cx - w / 2, cy - ln / 2, cx + w / 2, cy + ln / 2, ang],
        -1).astype(np.float32))


def _iou(geo_r, area_r, geo_c, area_c, rotated):
    """(G, M, N) IoU of rows against columns, entry for entry as the eager
    loop computes it: `geo` corners (G, ., 4, 2) (rotated) or boxes
    (G, ., 5), `area` (G, .)."""
    if rotated:
        inter = rotated_overlap.pair_overlap_batched_plain(geo_r, geo_c)
    else:
        r, c = geo_r[:, :, None], geo_c[:, None]
        iw = torch.clamp(torch.minimum(r[..., 2], c[..., 2])
                         - torch.maximum(r[..., 0], c[..., 0]), min=0)
        ih = torch.clamp(torch.minimum(r[..., 3], c[..., 3])
                         - torch.maximum(r[..., 1], c[..., 1]), min=0)
        inter = iw * ih
    return inter / torch.clamp(area_r[:, :, None] + area_c[:, None, :]
                               - inter, min=1e-8)


def _geo_area(boxes5, rotated):
    geo = rotated_iou.boxes5_to_corners(boxes5) if rotated else boxes5
    return geo, ((boxes5[..., 2] - boxes5[..., 0])
                 * (boxes5[..., 3] - boxes5[..., 1]))


def _iou_matrix(top_boxes, rotated):
    """(G, pre, pre) IoU of row i against column j."""
    geo, area = _geo_area(top_boxes, rotated)
    return _iou(geo, area, geo, area, rotated)


def _sequential(boxes5, scores, thresh, pre, post, valid, rotated):
    """Greedy NMS one box at a time, on CPU copies, independent of the
    blocked loop and of kernels A and F: every group keeps its
    highest-ranked box still alive and kills each box that one overlaps
    above `thresh`, until `post` are kept or none is alive (a later box
    changes no earlier decision)."""
    boxes5, scores = boxes5.cpu(), scores.cpu()
    g, a = scores.shape
    pre = min(pre, a)
    ranked = (scores if valid is None
              else torch.where(torch.as_tensor(valid).cpu(), scores,
                               nms.NEG_INF))
    top_scores, order = nms.topk_stable(ranked, pre)
    top = torch.gather(boxes5, 1, order[:, :, None].expand(g, pre, 5))
    geo, area = _geo_area(top, rotated)
    alive = top_scores > nms.NEG_INF / 2
    kept = torch.zeros_like(alive)
    groups, ranks = torch.arange(g), torch.arange(pre)
    while True:
        go = alive.any(1) & (kept.sum(1) < post)
        if not bool(go.any()):
            break
        j = torch.where(alive, ranks, pre).argmin(1).clamp(max=pre - 1)
        row = _iou(geo[groups, j][:, None], area[groups, j][:, None], geo,
                   area, rotated)[:, 0]
        kept[groups[go], j[go]] = True
        alive &= ~((row > thresh) & go[:, None])
        alive[groups[go], j[go]] = False
    selected = torch.full((g, post), -1, dtype=torch.int32)
    for i in range(g):
        idx = order[i][kept[i]]
        selected[i, :len(idx)] = idx.to(torch.int32)
    return selected, kept.sum(1).to(torch.int32)


# (G, pre) of each configuration's NMS, rotated, and the cluster F takes:
# PointPillar and SECOND detect at B8 / B2 / B1, Part-A²'s proposal NMS (pre
# 9000) and its test / final NMS (pre 1024), the axis-aligned
# `nms_normal_gpu` at the proposal's shape; G changes no plan
PLANS = [('pointpillar_b8', 8, 4096, True, 16),
         ('second_b2', 2, 4096, True, 16),
         ('detect_b1', 1, 4096, True, 16),
         ('parta2_proposal_b8', 8, 9000, True, 16),
         ('parta2_proposal_b2', 2, 9000, True, 16),
         ('parta2_test_b2', 2, 1024, True, 8),
         ('parta2_final_b8', 8, 1024, True, 8),
         ('normal_proposal_b2', 2, 9000, False, 16),
         ('pre_under_block', 8, 40, True, 1),
         ('pre_300', 2, 300, True, 2),
         ('pre_1000', 3, 1000, True, 4),
         ('detect_b64', 64, 4096, True, 16)]


@pytest.mark.parametrize('name,g,pre,rotated,cluster', PLANS,
                         ids=[p[0] for p in PLANS])
def test_launch_plan(name, g, pre, rotated, cluster):
    c, cols, smem = nms_fused.plan(pre, rotated)
    assert c == cluster
    assert c <= 16 and cols % 32 == 0 and c * cols >= pre
    assert (c - 1) * cols < pre or c == 1
    assert smem == nms_fused.smem_bytes(cols, rotated)
    assert smem <= nms_fused.SMEM_MAX <= H100_SMEM_PER_SM
    assert c == 1 or -(-pre // c) >= nms_fused.MIN_COLS
    # one CTA more a group would leave a CTA fewer than MIN_COLS columns
    assert c == 16 or -(-pre // (2 * c)) < nms_fused.MIN_COLS


def test_launch_plan_limits():
    # the most CTAs that keep MIN_COLS columns each
    assert nms_fused.plan(16 * 128, True)[:2] == (16, 128)
    assert nms_fused.plan(16 * 128 - 32, True)[:2] == (8, 256)
    assert nms_fused.plan(1, True)[:2] == (1, 32)
    # past 16 CTAs' shared memory F refuses: 44,032 rotated columns
    top = 16 * 2752
    assert nms_fused.plan(top, True)[:2] == (16, 2752)
    with pytest.raises(ValueError):
        nms_fused.plan(top + 1, True)
    assert nms_fused.plan(top + 1, False)[0] == 16
    # more shared memory with more columns, the pair list only when rotated
    sizes = [nms_fused.smem_bytes(c, True) for c in range(32, 4097, 32)]
    assert sizes == sorted(sizes)
    assert (nms_fused.smem_bytes(256, True) - nms_fused.smem_bytes(256, False)
            > nms_fused.BLOCK * nms_fused.CHUNK * 2)


@pytest.mark.parametrize('bad', ['device', 'dtype', 'shape', 'pre'])
def test_fused_wrapper_refuses_without_launching(bad):
    g, pre = 2, 96
    geo = torch.zeros(g, pre, 4, 2)
    area = torch.ones(g, pre)
    valid = torch.ones(g, pre, dtype=torch.bool)
    if bad == 'dtype':
        area = area.double()
    elif bad == 'shape':
        geo = geo[:, :64]
    elif bad == 'pre':
        pre = 16 * 2752 + 1
        geo = torch.zeros(1, pre, 4, 2)
        area, valid = torch.ones(1, pre), torch.ones(1, pre, dtype=torch.bool)
    before = rotated_overlap.LAUNCHES, nms_fused.LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        nms_fused.greedy(geo, area, valid, 0.1, 100, True)
    assert (rotated_overlap.LAUNCHES, nms_fused.LAUNCHES) == before


@pytest.mark.parametrize('rotated', [True, False])
def test_cpu_tensors_take_the_eager_loop(monkeypatch, rotated):
    def refuse(*a, **k):
        raise AssertionError('kernel F on a CPU tensor')

    rounds = []
    eager = nms._lazy_greedy_batched

    def spy(*a, **k):
        rounds.append(1)
        return eager(*a, **k)

    monkeypatch.setattr(nms_fused, 'greedy', refuse)
    monkeypatch.setattr(nms, '_lazy_greedy_batched', spy)
    rng = np.random.RandomState(3)
    g, a, pre, post = 3, 300, 200, 40
    boxes = _boxes5(rng, g, a, 12.0)
    scores = torch.as_tensor(rng.randn(g, a).astype(np.float32))
    valid = torch.as_tensor(rng.rand(g, a) > 0.2)
    got = nms.nms_bev_batched(boxes, scores, 0.1, pre_max=pre, post_max=post,
                              valid_mask=valid, rotated=rotated)
    want = _sequential(boxes, scores, 0.1, pre, post, valid, rotated)
    assert rounds == [1]
    for x, w in zip(got, want):
        assert torch.equal(x, w)
    assert int(want[1].min()) > 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_boxes5_to_corners_signs(dtype):
    boxes = _boxes5(np.random.RandomState(5), 4, 50, 30.0).to(dtype)
    got = rotated_iou.boxes5_to_corners(boxes)
    x1, y1, x2, y2, ang = [boxes[..., i] for i in range(5)]
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    ox = ((x2 - x1) / 2)[..., None] * torch.tensor([1.0, -1.0, -1.0, 1.0],
                                                   dtype=dtype)
    oy = ((y2 - y1) / 2)[..., None] * torch.tensor([1.0, 1.0, -1.0, -1.0],
                                                   dtype=dtype)
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    want = torch.stack([ox * c + oy * s + cx[..., None],
                        -ox * s + oy * c + cy[..., None]], -1)
    assert got.dtype == dtype and torch.equal(got, want)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: kernel F has no CPU mode')
    return torch.device('cuda')


def _eager_overlap(a, b):
    """Kernel A through the eager loop (any overlap_fn but the default's
    object takes it)."""
    return rotated_overlap.pair_overlap_batched(a, b)


def _eager(boxes, scores, thresh, pre, post, valid, rotated):
    """The eager loop on the card -> (selected, num, rounds)."""
    calls = []
    suppress = nms._greedy_suppress_batched

    def counted(*a, **k):
        calls.append(1)
        return suppress(*a, **k)

    nms._greedy_suppress_batched = counted
    try:
        sel, num = nms.nms_bev_batched(
            boxes, scores, thresh, pre_max=pre, post_max=post,
            valid_mask=valid, rotated=rotated, overlap_fn=_eager_overlap)
    finally:
        nms._greedy_suppress_batched = suppress
    return sel, num, len(calls)


def _case(name, rng):
    """(boxes5, scores, valid, thresh, pre, post) on the CPU."""
    if name in ('pointpillar_b8', 'second_b2', 'g1'):
        g = {'pointpillar_b8': 8, 'second_b2': 2, 'g1': 1}[name]
        return (_boxes5(rng, g, 8000, 35.0), rng.randn(g, 8000),
                rng.rand(g, 8000) > 0.05, 0.01, 4096, 500)
    if name == 'parta2_proposal':
        return (_boxes5(rng, 2, 12000, 35.0), rng.randn(2, 12000),
                np.ones((2, 12000), bool), 0.8, 9000, 512)
    if name == 'parta2_test':
        return (_boxes5(rng, 2, 1500, 20.0), rng.randn(2, 1500),
                np.ones((2, 1500), bool), 0.7, 1024, 100)
    if name == 'pre_under_block':
        return (_boxes5(rng, 2, 40, 4.0), rng.randn(2, 40),
                rng.rand(2, 40) > 0.1, 0.1, 40, 500)
    if name == 'pre_ragged':
        return (_boxes5(rng, 3, 1500, 15.0), rng.randn(3, 1500),
                rng.rand(3, 1500) > 0.1, 0.2, 1000, 300)
    if name == 'post_inside_block':
        return (_boxes5(rng, 8, 2000, 60.0), rng.randn(8, 2000),
                np.ones((8, 2000), bool), 0.5, 2000, 10)
    if name == 'all_invalid':
        return (_boxes5(rng, 2, 500, 10.0), rng.randn(2, 500),
                np.zeros((2, 500), bool), 0.1, 300, 100)
    if name == 'all_kept':      # a grid 6 m apart, boxes under 4.3 m across
        gx, gy = np.meshgrid(np.arange(20) * 6.0, np.arange(20) * 6.0)
        b = _boxes5(rng, 2, 400, 0.0, size=(1.0, 3.0)).numpy()
        b[..., [0, 2]] += gx.reshape(-1, 1)
        b[..., [1, 3]] += gy.reshape(-1, 1)
        return (torch.as_tensor(b), rng.randn(2, 400),
                np.ones((2, 400), bool), 0.01, 400, 500)
    if name == 'tied_scores':
        return (_boxes5(rng, 4, 3000, 25.0),
                np.round(rng.randn(4, 3000), 1), rng.rand(4, 3000) > 0.1,
                0.05, 2048, 300)
    if name == 'duplicates':
        b = _boxes5(rng, 2, 700, 20.0)
        return (b.repeat(1, 3, 1), np.tile(rng.randn(2, 700), 3),
                np.ones((2, 2100), bool), 0.3, 2100, 500)
    raise ValueError(name)


CASES = ['pointpillar_b8', 'second_b2', 'g1', 'parta2_proposal',
         'parta2_test', 'pre_under_block', 'pre_ragged', 'post_inside_block',
         'all_invalid', 'all_kept', 'tied_scores', 'duplicates']


@pytest.mark.gpu
@pytest.mark.parametrize('rotated', [True, False], ids=['rotated', 'normal'])
@pytest.mark.parametrize('name', CASES)
def test_fused_equals_eager(cuda, name, rotated):
    rng = np.random.RandomState(sum(map(ord, name)))
    boxes, scores, valid, thresh, pre, post = _case(name, rng)
    boxes = boxes.to(cuda)
    scores = torch.as_tensor(np.asarray(scores, np.float32), device=cuda)
    valid = torch.as_tensor(valid, device=cuda)
    before = rotated_overlap.LAUNCHES, nms_fused.LAUNCHES
    sel, num = nms.nms_bev_batched(boxes, scores, thresh, pre_max=pre,
                                   post_max=post, valid_mask=valid,
                                   rotated=rotated)
    assert (rotated_overlap.LAUNCHES, nms_fused.LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    rounds = nms.last_device_rounds().cpu()
    want_sel, want_num, _ = _eager(boxes, scores, thresh, pre, post, valid,
                                   rotated)
    assert torch.equal(sel, want_sel) and torch.equal(num, want_num)
    # and the one-box-at-a-time greedy on the CPU, outside the port's loop
    seq_sel, seq_num = _sequential(boxes, scores, thresh, pre, post, valid,
                                   rotated)
    assert torch.equal(sel.cpu(), seq_sel) and torch.equal(num.cpu(), seq_num)
    for i in range(boxes.shape[0]):   # each group's rounds, alone
        one = _eager(boxes[i:i + 1], scores[i:i + 1], thresh, pre, post,
                     valid[i:i + 1], rotated)
        assert torch.equal(one[0], want_sel[i:i + 1])
        assert int(rounds[i]) == one[2], (i, rounds.tolist())
    if name == 'all_invalid':
        assert int(num.max()) == 0 and int(rounds.max()) == 0
    if name == 'all_kept':
        assert int(num.min()) == 400
    if name == 'post_inside_block':
        assert int(num.min()) == post and int(rounds.max()) == 1
    if name == 'pointpillar_b8' and rotated:
        assert int(rounds.min()) > 3


@pytest.mark.gpu
@pytest.mark.parametrize('rotated', [True, False], ids=['rotated', 'normal'])
def test_iou_exactly_at_thresh(cuda, rotated):
    """Two overlapping boxes whose IoU is the threshold itself: the lower
    is kept (a strict `>`), and a threshold one ulp under it suppresses."""
    rng = np.random.RandomState(11)
    boxes = _boxes5(rng, 1, 200, 200.0, size=(1.0, 2.0))
    boxes[0, 0] = torch.tensor([0.0, 0.0, 4.0, 2.0, 0.3])
    boxes[0, 1] = torch.tensor([1.0, 0.5, 5.0, 2.5, 0.1])
    if not rotated:
        boxes[0, :2, 4] = 0.0
    scores = torch.linspace(1.0, 0.0, 200)[None]
    iou = float(_iou_matrix(boxes[:, :2], rotated)[0, 0, 1])
    assert 0.0 < iou < 1.0
    for thresh, kept in ((iou, True),
                         (float(np.nextafter(np.float32(iou),
                                             np.float32(0))), False)):
        args = (boxes.to(cuda), scores.to(cuda), thresh)
        sel, num = nms.nms_bev_batched(*args, pre_max=200, post_max=300,
                                       rotated=rotated)
        want = _eager(*args, 200, 300, None, rotated)
        assert torch.equal(sel, want[0]) and torch.equal(num, want[1])
        assert (1 in sel[0].tolist()) == kept


@pytest.mark.gpu
@pytest.mark.parametrize('rotated', [True, False], ids=['rotated', 'normal'])
def test_per_class_nms(cuda, monkeypatch, rotated):
    rng = np.random.RandomState(7)
    b, a, k = 2, 6000, 3
    centers = rng.uniform(-30, 30, (b, a, 3))
    dims = rng.uniform(1, 5, (b, a, 3))
    box_preds = torch.as_tensor(np.concatenate(
        [centers, dims, rng.uniform(-np.pi, np.pi, (b, a, 1))], -1)
        .astype(np.float32), device=cuda)
    cls_preds = torch.as_tensor(rng.randn(b, a, k).astype(np.float32),
                                device=cuda)
    args = (cls_preds, box_preds, 0.3, 0.1, 2048, 200)
    before = nms_fused.LAUNCHES
    got = detector3d.multi_classes_nms_batched(*args, rotated=rotated)
    assert nms_fused.LAUNCHES == before + k
    fused = nms.nms_bev_batched
    monkeypatch.setattr(nms, 'nms_bev_batched', lambda *x, **y: fused(
        *x, **y, overlap_fn=_eager_overlap))
    want = detector3d.multi_classes_nms_batched(*args, rotated=rotated)
    assert int(want['num'].min()) > 0
    for key in want:
        assert torch.equal(got[key], want[key]), key

    def sequential(boxes5, scores, thresh, pre_max, post_max, valid_mask,
                   rotated):
        return tuple(x.to(boxes5.device) for x in _sequential(
            boxes5, scores, thresh, pre_max, post_max, valid_mask, rotated))

    monkeypatch.setattr(nms, 'nms_bev_batched', sequential)
    want = detector3d.multi_classes_nms_batched(*args, rotated=rotated)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.gpu
def test_no_host_sync(cuda):
    rng = np.random.RandomState(2)
    boxes = _boxes5(rng, 8, 8000, 35.0).to(cuda)
    scores = torch.as_tensor(rng.randn(8, 8000).astype(np.float32),
                             device=cuda)
    valid = scores > -1.5
    for rotated in (True, False):
        nms.nms_bev_batched(boxes, scores, 0.01, valid_mask=valid,
                            rotated=rotated)          # builds, plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        for rotated in (True, False):
            out = nms.nms_bev_batched(boxes, scores, 0.01, valid_mask=valid,
                                      rotated=rotated)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out[1].min()) > 0


@pytest.mark.gpu
def test_smem_mirror(cuda):
    lib = nms_fused.build()
    for rotated in (True, False):
        for cols in (32, 64, 128, 256, 576, 2272, 2752):
            assert lib.pcdet_nms_fused_smem_bytes(int(rotated), cols) == \
                nms_fused.smem_bytes(cols, rotated)
