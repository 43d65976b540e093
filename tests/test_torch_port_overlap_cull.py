"""Kernel A's cull, proven on the CPU: every pair the plain predicate
`overlap_maybe_nonzero_plain` discards has a plain area of exactly +0.0.

Kernel A (`pcdet_tpu_torch/csrc/rotated_overlap.cu`) writes +0.0 for the
pairs the predicate discards and clips the rest as before, so it stays
bitwise equal to its plain version (and to the JAX package's edge-clip
kernel's zeros) only if this holds.  The kernel's header argues it; these
tests judge it on over 10^6 pairs built to be hard: near misses just past
the cull gap at every angle, nearly parallel facing edges, slivers down to
the 1 mm edge floor, convex quads that are not rectangles, boxes of 0.1-7 m
at centres out to +-80 m, and a hypothesis search.  Degenerate quads (all
four corners one point, a zero-length side), clockwise ones, NaN and Inf
must never be discarded: against a one-point quad the plain version
returns the whole area of the other box.  Exact comparisons throughout (no
tolerance): the claim is bit-for-bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from pcdet_tpu_torch.ops import rotated_iou, rotated_overlap as ro

torch.set_num_threads(1)

GAP = ro.CULL_GAP


def _rects(cx, cy, w, l, ang):
    """float64 (P,) box parameters -> (P, 4, 2) CCW corners, as
    `boxes5_to_corners` lays them out."""
    ox = (w / 2)[:, None] * np.array([1.0, -1.0, -1.0, 1.0])
    oy = (l / 2)[:, None] * np.array([1.0, 1.0, -1.0, -1.0])
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    return np.stack([ox * c + oy * s + cx[:, None],
                     -ox * s + oy * c + cy[:, None]], -1)


def _convex_quads(rng, p, cx, cy):
    """(P, 4, 2) convex CCW quads that are not rectangles: four sorted
    angles on an ellipse of random stretch, near the quarters for most
    (cullable), anywhere for a fifth (some corners sharp)."""
    quarters = (np.arange(4) * np.pi / 2 + rng.uniform(0, 2 * np.pi, (p, 1))
                + rng.uniform(-0.7, 0.7, (p, 4)))
    t = np.sort(np.where(rng.rand(p, 1) < 0.8, quarters,
                         rng.uniform(0, 2 * np.pi, (p, 4))), 1)
    rx = rng.uniform(0.05, 3.5, (p, 1))
    ry = rx * np.exp(rng.uniform(-1.5, 1.5, (p, 1)))
    rot = rng.uniform(-np.pi, np.pi, (p, 1))
    x, y = rx * np.cos(t), ry * np.sin(t)
    c, s = np.cos(rot), np.sin(rot)
    return np.stack([x * c - y * s + cx[:, None], x * s + y * c + cy[:, None]],
                    -1)


def _pairs(kind, p, seed):
    """(corners A, corners B) of `p` hard pairs of one kind, f32, each
    (p, 1, 4, 2) so that the grid (p, 1, 1) is the pairs themselves."""
    rng = np.random.RandomState(seed)
    cx, cy = rng.uniform(-80, 80, p), rng.uniform(-80, 80, p)
    size = (lambda: rng.uniform(0.1, 7.0, p))
    ang = (lambda: rng.uniform(-np.pi, np.pi, p))
    if kind == 'near_miss':
        qa = _rects(cx, cy, size(), size(), ang())
        qb = _rects(cx, cy, size(), size(), ang())
    elif kind == 'parallel':      # facing edges nearly parallel to the gap
        base = rng.randint(0, 4, p) * np.pi / 2
        jitter = rng.choice([0.0, 1e-7, 1e-5, 1e-3], p) * rng.choice([-1, 1], p)
        a = base + rng.choice([0.0, 1e-6, 1e-4], p) * rng.choice([-1, 1], p)
        qa = _rects(cx, cy, size(), size(), a)
        qb = _rects(cx, cy, size(), size(),
                    a + jitter + rng.randint(0, 4, p) * np.pi / 2)
    elif kind == 'slivers':       # one side 0.5 mm to 0.1 m
        thin = (lambda: np.exp(rng.uniform(np.log(5e-4), np.log(0.1), p)))
        qa = _rects(cx, cy, thin(), size(), ang())
        qb = _rects(cx, cy, size(), thin(), ang())
    elif kind == 'quads':
        qa = _convex_quads(rng, p, cx, cy)
        qb = _convex_quads(rng, p, cx, cy)
    else:
        raise ValueError(kind)
    # gaps from just past the cull gap to 3x it, and a quarter inside it
    gap = GAP * np.where(rng.rand(p) < 0.75,
                         1.0 + np.exp(rng.uniform(np.log(1e-4), np.log(2.0),
                                                  p)),
                         rng.uniform(0.0, 1.0, p))
    qa, qb = chip_smoke.place_beside(qa, qb, gap, rng.randint(0, 2, p),
                                     rng.randint(0, 2, p), rng.rand(p))
    return (torch.as_tensor(qa)[:, None].contiguous(),
            torch.as_tensor(qb)[:, None].contiguous())


def _assert_culled_zero(ca, cb):
    """Every discarded pair's plain area is +0.0; returns (discarded,
    pairs)."""
    keep = ro.overlap_maybe_nonzero_plain(ca, cb)
    area = ro.pair_overlap_batched_plain(ca, cb)
    culled = area[~keep]
    assert torch.equal(culled, torch.zeros_like(culled)), \
        culled[culled != 0][:5]
    assert not bool(torch.signbit(culled).any()), 'a culled pair gives -0.0'
    return int((~keep).sum()), keep.numel()


@pytest.mark.parametrize('kind,p', [('near_miss', 320000),
                                    ('parallel', 240000),
                                    ('slivers', 240000),
                                    ('quads', 240000)])
def test_cull_discards_only_zero_areas(kind, p):
    ca, cb = _pairs(kind, p, seed=len(kind))
    culled, pairs = _assert_culled_zero(ca, cb)
    assert culled > 0.3 * pairs          # the pairs are near misses culled
    # the predicate is the gap rule and nothing looser: the pairs placed
    # inside the gap are all kept
    keep = ro.overlap_maybe_nonzero_plain(ca, cb)
    box_a, box_b = ro.cull_boxes_plain(ca), ro.cull_boxes_plain(cb)
    gap = torch.maximum(
        torch.maximum(box_b[..., 0] - box_a[..., 1],
                      box_a[..., 0] - box_b[..., 1]),
        torch.maximum(box_b[..., 2] - box_a[..., 3],
                      box_a[..., 2] - box_b[..., 3]))[..., None]
    assert bool(keep[gap < 0.999 * GAP].all())


def test_cull_on_nms_grid():
    """chip_smoke's NMS-shape grid (seed 0, G=2, M=64, N=4096, centres to
    +-30 m): 2.06% of the pairs kept, every nonzero area among them."""
    rng = np.random.RandomState(0)
    cb = rotated_iou.boxes5_to_corners(torch.as_tensor(
        chip_smoke.rand_boxes5(rng, (2, 4096)))).contiguous()
    ca = cb[:, :64].contiguous()
    culled, pairs = _assert_culled_zero(ca, cb)
    assert pairs == 524288 and 0.97 < culled / pairs < 0.99


_W = st.floats(0.1, 7.0)
_C = st.floats(-80.0, 80.0)
_A = st.floats(-np.pi, np.pi)


@settings(max_examples=400, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ax=_C, ay=_C, aw=_W, al=_W, aa=_A, bw=_W, bl=_W, ba=_A,
       axis=st.integers(0, 1), side=st.integers(0, 1),
       across=st.floats(0.0, 1.0),
       excess=st.one_of(st.floats(0.0, 3.0), st.floats(0.0, 1e-3)))
def test_cull_property_hypothesis(ax, ay, aw, al, aa, bw, bl, ba, axis,
                                  side, across, excess):
    """A searched pair placed `GAP * (1 + excess)` apart: culled -> +0.0."""
    qa = _rects(*(np.array([v]) for v in (ax, ay, aw, al, aa)))
    qb = _rects(*(np.array([v]) for v in (ax, ay, bw, bl, ba)))
    qa, qb = chip_smoke.place_beside(qa, qb, GAP * (1.0 + excess),
                                     np.array([axis]), np.array([side]),
                                     np.array([across]))
    ca = torch.as_tensor(qa)[:, None].contiguous()
    cb = torch.as_tensor(qb)[:, None].contiguous()
    _assert_culled_zero(ca, cb)
    _assert_culled_zero(cb, ca)


def _odd_quads():
    """Quads the cull must never discard against: one point (the
    zero-padded rows of the recall grid), a zero-length side, a segment,
    clockwise, a corner past W, NaN, Inf."""
    pt = np.full((4, 2), 5.0)
    side0 = _rects(*(np.array([v]) for v in (3.0, 3.0, 2.0, 4.0, 0.3)))[0]
    side0[1] = side0[0]
    seg = _rects(*(np.array([v]) for v in (0.0, 0.0, 0.0, 4.0, 0.7)))[0]
    cw = _rects(*(np.array([v]) for v in (-3.0, 2.0, 2.0, 4.0, 0.2)))[0][::-1]
    far = _rects(*(np.array([v]) for v in (300.0, 0.0, 2.0, 4.0, 0.0)))[0]
    nan = side0.copy()
    nan[2, 1] = np.nan
    inf = _rects(*(np.array([v]) for v in (0.0, 0.0, 2.0, 4.0, 0.0)))[0]
    inf[0, 0] = np.inf
    return np.stack([np.zeros((4, 2)), pt, side0, seg, cw, far, nan, inf]
                    ).astype(np.float32)


def test_cull_never_discards_degenerate_quads():
    rng = np.random.RandomState(3)
    odd = torch.as_tensor(_odd_quads())
    boxes = rotated_iou.boxes5_to_corners(torch.as_tensor(
        chip_smoke.rand_boxes5(rng, 300, spread=80.0))).contiguous()
    assert torch.equal(ro.cull_boxes_plain(odd)[:, 1],
                       torch.full((8,), torch.inf))
    assert bool(ro.overlap_maybe_nonzero_plain(odd[None], boxes[None]).all())
    assert bool(ro.overlap_maybe_nonzero_plain(boxes[None], odd[None]).all())
    # the trap: a one-point quad as B gives A's whole area, wherever it is
    area = ro.pair_overlap_batched_plain(boxes[None, :4], odd[None, :2])
    want = rotated_iou.quad_intersection_area(boxes[:4], boxes[:4])
    assert torch.equal(area[0, :, 0], want) and torch.equal(area[0, :, 1], want)


def test_one_point_quads_closed_form():
    """Kernel A computes a kept pair with a one-point quad in closed form;
    the plain version agrees bit for bit: +0.0 when A is the point; when B
    is, A's four edge integrals at ds = 1 summed in order, plus +0.0, then
    max with 0 (`point_b_area` in the kernel)."""
    rng = np.random.RandomState(6)
    a = rotated_iou.boxes5_to_corners(torch.as_tensor(
        chip_smoke.rand_boxes5(rng, 2000, spread=80.0)))
    a[::7] = torch.as_tensor(_convex_quads(
        rng, len(a[::7]), np.zeros(len(a[::7])),
        np.zeros(len(a[::7]))).astype(np.float32))
    a[::11, 2] = a[::11, 1]                        # a zero-length side
    pts = torch.as_tensor(np.concatenate([
        np.zeros((1, 2)), rng.uniform(-80, 80, (1999, 2))]).astype(np.float32))
    pts[5] = a[5].mean(0)                          # inside its box
    pt = pts[:, None].expand(-1, 4, 2).contiguous()
    with_b_point = ro.pair_overlap_batched_plain(a[:, None], pt[:, None])
    x, y = a[..., 0], a[..., 1]
    acc = torch.zeros(len(a))
    for i in range(4):
        dx = x[:, (i + 1) % 4] - x[:, i]
        dy = y[:, (i + 1) % 4] - y[:, i]
        acc = acc + dy * (x[:, i] * 1.0 + 0.5 * dx * (1.0 + 0.0) * 1.0)
    want = torch.clamp(acc + 0.0, min=0.0)
    assert torch.equal(with_b_point[:, 0, 0], want)
    assert not bool(torch.signbit(want).any())
    with_a_point = ro.pair_overlap_batched_plain(pt[:, None], a[:, None])
    assert torch.equal(with_a_point, torch.zeros_like(with_a_point))
    assert not bool(torch.signbit(with_a_point).any())


def test_cull_on_crafted_pairs():
    """chip_smoke's crafted pairs: identical, contained, edge-sharing and
    turned pairs are kept; the disjoint one at (100, 100) is discarded."""
    a, b = (rotated_iou.boxes5_to_corners(torch.as_tensor(x))[None]
            for x in chip_smoke.crafted_boxes5())
    keep = ro.overlap_maybe_nonzero_plain(a, b)[0]
    assert torch.diagonal(keep).tolist() == [True, True, False, True, True,
                                             True]
    assert not bool(keep[:, 2].any())
    _assert_culled_zero(a, b)


def test_cull_on_recall_grid_layout():
    """A B8 recall grid (500 predictions x 128 GT a sample, boxes7 to BEV
    corners) with zero-padded prediction and GT rows: every pair with a
    zero row is kept, the discarded pairs are +0.0."""
    preds, gt = (torch.as_tensor(x) for x in
                 chip_smoke.recall_grid_boxes7(np.random.RandomState(4)))
    ca = rotated_iou.boxes7_to_corners(preds)
    cb = rotated_iou.boxes7_to_corners(gt)
    keep = ro.overlap_maybe_nonzero_plain(ca, cb)
    zero_a = (preds == 0).all(-1)
    zero_b = (gt == 0).all(-1)
    assert bool(keep[zero_a].all()) and bool(keep.transpose(1, 2)[zero_b].all())
    culled, pairs = _assert_culled_zero(ca, cb)
    assert culled > 0


def test_counted_on_cpu_is_plain_and_the_predicate():
    rng = np.random.RandomState(5)
    c = rotated_iou.boxes5_to_corners(torch.as_tensor(
        chip_smoke.rand_boxes5(rng, (2, 300)))).contiguous()
    c[1, 7] = 0.0                                  # a zero-padded row
    before = ro.LAUNCHES
    area, count = ro.pair_overlap_batched_counted(c[:, :40].contiguous(), c)
    assert ro.LAUNCHES == before
    assert torch.equal(area, ro.pair_overlap_batched_plain(c[:, :40], c))
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(ro.overlap_maybe_nonzero_plain(
        c[:, :40], c).sum())


def test_culled_pairs_are_zero_in_pallas_interpret():
    """The JAX package's edge-clip kernel (Pallas, interpret mode) gives 0
    on the pairs the predicate discards, on near misses placed in a grid."""
    from jax.experimental.pallas import tpu as pltpu
    from pcdet_tpu.ops.pallas import rotated_overlap as pallas_ro

    ca, cb = _pairs('near_miss', 140, seed=9)
    ca = ca[:24, 0][None].contiguous()            # (1, 24) x (1, 140): the
    cb = cb[:, 0][None].contiguous()              # diagonal pairs are near
    keep = ro.overlap_maybe_nonzero_plain(ca, cb)
    assert int((~torch.diagonal(keep[0])).sum()) > 5
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_ro.pair_overlap_batched(
            jnp.asarray(ca.numpy()), jnp.asarray(cb.numpy())))
    assert (want[~keep.numpy()] == 0).all()
    _assert_culled_zero(ca, cb)
