"""Kernel A″'s compacted order, proven on the CPU: the work on the valid
candidates only gives `pair_overlap_sorted_plain`'s areas bit for bit.

Kernel A″ (`pcdet_tpu_torch/csrc/rotated_overlap_sorted.cu`) generates the
candidates in slot order, appends each valid one to a list unless an
accepted one lies within 1e-6 of it, and runs the centroid, the angles,
the successor scan and the shoelace over that list only; its header argues
that this is exact.  `compacted_area` below is that order for one pair,
in numpy float32 scalars (each operation rounded on its own, as the kernel
built with --fmad=false rounds it), and the tests hold it to the plain
version (24 slots, masks, sums over every slot) with `.view(np.uint32)`
equality on random boxes within 6 m, a recall-grid-shaped grid with
zero-padded rows on both sides (one-point quads at the origin) and the
crafted quads of `chip_smoke.sorted_crafted_quads`, every ordered pair:
identical and turned boxes, shared edges and corners, collinear
overlapping edges, containment, boxes at 60-68 m, one-point quads inside
and outside a box, quads with a zero-length side, collinear candidates at
one pseudo-angle (a tie in the successor scan) and a box against itself
turned by micro-radians (16 accepted candidates), and on finite corners
whose products overflow (`chip_smoke.overflow_quads`: areas of +inf and
NaN).  They also hold its counts of the work the kernel reaches (the
crossings past each test, the dedup tests) to `sorted_work_plain`, from
which chip_smoke.py counts the kernel's operations.  The recall-shaped
grid also holds the plain version to the Pallas `pair_overlap_sorted` in
interpret mode (the 24-slot sums run in another order in XLA: AREA_TOL
2e-5, within 6 m, as tests/test_torch_port_eval.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from pcdet_tpu.ops.pallas import rotated_overlap as jax_overlap
from pcdet_tpu_torch.ops import rotated_iou
from pcdet_tpu_torch.ops import rotated_overlap as ro

torch.set_num_threads(1)

F = np.float32
EPS, INSIDE_EPS, DUP_TOL, BIG = F(ro.EPS), F(ro.INSIDE_EPS), F(ro.DUP_TOL), \
    F(ro.BIG)
AREA_TOL = 2e-5


def _cross(ox, oy, px, py, qx, qy):
    return (px - ox) * (qy - oy) - (qx - ox) * (py - oy)


def _inside(qx, qy, px, py):
    return all(_cross(qx[e], qy[e], qx[(e + 1) % 4], qy[(e + 1) % 4], px, py)
               >= -INSIDE_EPS for e in range(4))


def _diamond_angle(dx, dy):
    adx, ady = abs(dx), abs(dy)
    denom = np.maximum(adx + ady, EPS)           # NaN stays, as torch.clamp
    pos_x, pos_y = dx >= 0, dy >= 0
    if pos_x and pos_y:
        return dy / denom
    if not pos_x and pos_y:
        return F(1) + adx / denom
    if not pos_x and not pos_y:
        return F(2) + ady / denom
    return F(3) + dx / denom


WORK = ('length', 'denom_ok', 't_ok', 'crossings', 'dedup_tests')


def compacted_area(qa, qb):
    """(area, work) of one pair of (4, 2) float32 quads, in the kernel's
    compacted order; `work` counts what `ro.sorted_work_plain` counts, as
    the kernel reaches it."""
    ax, ay = [F(v) for v in qa[:, 0]], [F(v) for v in qa[:, 1]]
    bx, by = [F(v) for v in qb[:, 0]], [F(v) for v in qb[:, 1]]
    accepted = []
    work = dict.fromkeys(WORK, 0)

    def accept(x, y):
        for lx, ly in accepted:
            work['dedup_tests'] += 1
            if abs(lx - x) < DUP_TOL and abs(ly - y) < DUP_TOL:
                return
        accepted.append((x, y))

    # 1. and 2. in slot order: A's corners, B's corners, the crossings
    for k in range(4):
        if _inside(bx, by, ax[k], ay[k]):
            accept(ax[k], ay[k])
    for k in range(4):
        if _inside(ax, ay, bx[k], by[k]):
            accept(bx[k], by[k])
    for i in range(4):
        rx, ry = ax[(i + 1) % 4] - ax[i], ay[(i + 1) % 4] - ay[i]
        for j in range(4):
            sx, sy = bx[(j + 1) % 4] - bx[j], by[(j + 1) % 4] - by[j]
            denom = rx * sy - ry * sx
            if not abs(denom) > EPS:
                continue
            work['denom_ok'] += 1
            qpx, qpy = bx[j] - ax[i], by[j] - ay[i]
            t = (qpx * sy - qpy * sx) / denom
            if not (t >= 0 and t <= 1):
                continue
            work['t_ok'] += 1
            u = (qpx * ry - qpy * rx) / denom
            if not (u >= 0 and u <= 1):
                continue
            work['crossings'] += 1
            accept(ax[i] + t * rx, ay[i] + t * ry)
    n = work['length'] = len(accepted)
    if n < 3:
        return F(0), work

    # 3. centroid and angles over the list
    count, sx, sy = F(n), F(0), F(0)
    for x, y in accepted:
        sx = sx + x
        sy = sy + y
    cx, cy = sx / count, sy / count
    ang = [_diamond_angle(x - cx, y - cy) for x, y in accepted]

    # 4. successor by the least positive gap, j ascending; shoelace
    area2 = F(0)
    for i, (xi, yi) in enumerate(accepted):
        best, nx, ny = BIG, xi, yi
        for j, (xj, yj) in enumerate(accepted):
            if j == i:
                continue
            gap = ang[j] - ang[i]
            if gap <= 0:
                gap = gap + F(4)
            if gap < best:
                best, nx, ny = gap, xj, yj
        if best < BIG / F(2):
            area2 = area2 + (xi * ny - nx * yi)
    return F(0.5) * abs(area2), work


def compacted_grid(ca, cb):
    """(G, M, 4, 2) x (G, N, 4, 2) float32 -> ((G, M, N) areas, {name:
    (G, M, N) counts}) by `compacted_area`."""
    g, m, n = ca.shape[0], ca.shape[1], cb.shape[1]
    areas = np.zeros((g, m, n), np.float32)
    work = {k: np.zeros((g, m, n), np.int64) for k in WORK}
    with np.errstate(all='ignore'):
        for gi in range(g):
            for mi in range(m):
                for ni in range(n):
                    areas[gi, mi, ni], w = compacted_area(ca[gi, mi],
                                                          cb[gi, ni])
                    for k in WORK:
                        work[k][gi, mi, ni] = w[k]
    return areas, work


def _check_bitwise(ca, cb):
    """The compacted order vs the plain version, bit for bit, and its work
    counts vs `sorted_work_plain` -> (plain areas, list lengths)."""
    a, b = torch.as_tensor(ca), torch.as_tensor(cb)
    plain = ro.pair_overlap_sorted_plain(a, b).numpy()
    got, work = compacted_grid(ca, cb)
    want = ro.sorted_work_plain(a, b)
    for k in WORK:
        np.testing.assert_array_equal(want[k].numpy(), work[k], err_msg=k)
    bad = np.argwhere(got.view(np.uint32) != plain.view(np.uint32))
    assert not len(bad), [(tuple(i), got[tuple(i)], plain[tuple(i)])
                          for i in bad[:5]]
    return plain, work['length']


def _corners5(boxes):
    return rotated_iou.boxes5_to_corners(torch.as_tensor(
        np.asarray(boxes, np.float32))).numpy()


def recall_shaped(seed=3, g=3, m=40, n=32):
    """(G, M, 4, 2), (G, N, 4, 2) corners shaped like a recall grid: boxes
    within 6 m, about half the rows of each side zero-padded (one-point
    quads at the origin)."""
    rng = np.random.RandomState(seed)
    ca = _corners5(chip_smoke.near_boxes5(rng, (g, m)))
    cb = _corners5(chip_smoke.near_boxes5(rng, (g, n)))
    for i in range(g):
        ca[i, rng.randint(m // 3, 2 * m // 3):] = 0.0
        cb[i, rng.randint(n // 3, 2 * n // 3):] = 0.0
    return ca, cb


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_compacted_order_is_plain_on_random_boxes(seed):
    rng = np.random.RandomState(seed)
    boxes = chip_smoke.near_boxes5(rng, (1, 36))
    ca, cb = _corners5(boxes[:, :18]), _corners5(boxes)
    plain, lens = _check_bitwise(ca, cb)
    assert (plain > 0).sum() > 20
    assert lens.max() >= 6


def test_compacted_order_is_plain_on_a_recall_shaped_grid():
    ca, cb = recall_shaped()
    plain, lens = _check_bitwise(ca, cb)
    pad_a = (ca == 0).reshape(*ca.shape[:2], 8).all(-1)
    pad_b = (cb == 0).reshape(*cb.shape[:2], 8).all(-1)
    both = pad_a[:, :, None] & pad_b[:, None]
    a_live_b_pad = ~pad_a[:, :, None] & pad_b[:, None]
    # padded x padded: one accepted point, area +0.0; a live box against a
    # padded column: its 4 corners (5 with the origin inside it)
    assert (lens[both] == 1).all() and (plain[both] == 0).all()
    assert set(np.unique(lens[a_live_b_pad])) <= {4, 5}
    assert (plain[a_live_b_pad] > 0).all()
    assert both.sum() > 100 and a_live_b_pad.sum() > 100


def test_plain_matches_pallas_on_a_recall_shaped_grid():
    ca, cb = recall_shaped()
    plain = ro.pair_overlap_sorted_plain(torch.as_tensor(ca),
                                         torch.as_tensor(cb)).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.stack([np.asarray(jax_overlap.pair_overlap_sorted(
            jnp.asarray(a), jnp.asarray(b))) for a, b in zip(ca, cb)])
    np.testing.assert_allclose(plain, want, rtol=0, atol=AREA_TOL)
    assert (want > 0).sum() > 1000


CRAFTED = chip_smoke.sorted_crafted_quads()
LONGEST = {'turned by micro-radians, long lists': 16}


@pytest.mark.parametrize('case', list(CRAFTED))
def test_compacted_order_is_plain_on_crafted_pairs(case):
    quads = CRAFTED[case]
    plain, lens = _check_bitwise(quads[None], quads[None])
    assert lens.max() >= LONGEST.get(case, 4), lens


def test_compacted_order_is_plain_with_overflowing_corners():
    """Finite corners whose products overflow: areas of +inf and NaN, the
    same bits in both orders."""
    quads = chip_smoke.overflow_quads()
    plain, _ = _check_bitwise(quads[None], quads[None])
    assert np.isnan(plain).any() and np.isposinf(plain).any()


def test_compacted_area_of_crafted_pairs():
    """The known areas (the sums differ from exact arithmetic by rounding)."""
    q = CRAFTED['identical and turned 90 degrees']
    area = lambda a, b: float(compacted_area(q[a], q[b])[0])
    assert area(0, 1) == pytest.approx(8.0, abs=2e-5)
    assert area(3, 4) == pytest.approx(16.0, abs=2e-5)
    q = CRAFTED['shared edge and shared corner']
    assert compacted_area(q[0], q[1])[0] == 0
    assert compacted_area(q[0], q[2])[0] == 0
    q = CRAFTED['collinear overlapping edges']
    assert float(compacted_area(q[0], q[2])[0]) == pytest.approx(4.0,
                                                                 abs=2e-5)
    assert float(compacted_area(q[0], q[1])[0]) == pytest.approx(2.0,
                                                                 abs=2e-5)
    # the tie: (2, 3)'s successor is (2, 0), the first at the least gap
    q = CRAFTED['collinear corners, tied angles']
    area, work = compacted_area(q[0], q[1])
    assert (area, work['length']) == (2.0, 3)
