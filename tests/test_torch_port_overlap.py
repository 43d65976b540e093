"""pcdet_tpu_torch rotated overlap vs pcdet_tpu (CPU).

The plain PyTorch edge-clip version (the kernel's twin) against
`pcdet_tpu.ops.rotated_iou` and against the Pallas kernel
`pair_overlap_batched` run in interpret mode, on the same corners made from
a numpy seed.

Tolerance: 1e-5 absolute on areas up to ~35.  Both sides run the same f32
formula, but XLA may fuse and contract the interpret-mode kernel's ops
(differences of a few 1e-6 seen), and the corners go through two
implementations of cos/sin (compared at 1e-5 too).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdet_tpu.ops import rotated_iou as jax_iou
from pcdet_tpu_torch.ops import rotated_iou, rotated_overlap

torch.set_num_threads(1)

ATOL = 1e-5


def _rand_boxes5(rng, shape, spread=6.0):
    cx = rng.uniform(-spread, spread, shape)
    cy = rng.uniform(-spread, spread, shape)
    dx = rng.uniform(0.5, 5.0, shape)
    dy = rng.uniform(0.5, 5.0, shape)
    ang = rng.uniform(-np.pi, np.pi, shape)
    return np.stack([cx - dx / 2, cy - dy / 2, cx + dx / 2, cy + dy / 2, ang],
                    axis=-1).astype(np.float32)


def _corners(boxes5):
    return np.array(jax_iou.boxes5_to_corners(jnp.asarray(boxes5)))


def test_boxes5_to_corners_matches_jax():
    b = _rand_boxes5(np.random.RandomState(0), (3, 50))
    got = rotated_iou.boxes5_to_corners(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, _corners(b), rtol=0, atol=1e-5)


def test_plain_overlap_matches_jax_edge_clip():
    rng = np.random.RandomState(1)
    ca, cb = _corners(_rand_boxes5(rng, 40)), _corners(_rand_boxes5(rng, 70))
    want = np.asarray(jax_iou.quad_intersection_area(
        jnp.asarray(ca)[:, None], jnp.asarray(cb)[None]))
    got = rotated_iou.quad_intersection_area(
        torch.as_tensor(ca)[:, None], torch.as_tensor(cb)[None]).numpy()
    assert (want > 0).sum() > 100          # many overlapping pairs
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_boxes_iou_bev_matches_jax():
    rng = np.random.RandomState(2)
    a, b = _rand_boxes5(rng, 30), _rand_boxes5(rng, 45)
    want = np.asarray(jax_iou.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    got = rotated_iou.boxes_iou_bev(torch.as_tensor(a),
                                    torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('g,m,n', [(2, 24, 140), (1, 64, 128), (3, 5, 7)])
def test_batched_matches_pallas_interpret(g, m, n):
    from jax.experimental.pallas import tpu as pltpu
    from pcdet_tpu.ops.pallas import rotated_overlap as pallas_ro

    rng = np.random.RandomState(3)
    cb = _corners(_rand_boxes5(rng, (g, n)))
    ca = np.ascontiguousarray(cb[:, :m]) if m <= n else \
        _corners(_rand_boxes5(rng, (g, m)))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_ro.pair_overlap_batched(jnp.asarray(ca),
                                                         jnp.asarray(cb)))
    got = rotated_overlap.pair_overlap_batched(torch.as_tensor(ca),
                                               torch.as_tensor(cb)).numpy()
    assert got.shape == (g, m, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_crafted_pairs():
    a = np.array([[-5, -5, 5, 5, 0.0]], np.float32)
    b = np.array([[-1, -1, 1, 1, 0.9],          # contained, rotated
                  [5, -1, 7, 1, 0.0],            # shares an edge: area 0
                  [100, 100, 102, 102, 0.3],     # disjoint
                  [-5, -5, 5, 5, np.pi / 2],     # same square turned 90°
                  [-5, -5, 5, 5, 0.0]], np.float32)  # identical
    got = rotated_overlap.pair_overlap(
        rotated_iou.boxes5_to_corners(torch.as_tensor(a)),
        rotated_iou.boxes5_to_corners(torch.as_tensor(b))).numpy()[0]
    np.testing.assert_allclose(got[[0, 3, 4]], [4.0, 100.0, 100.0], rtol=1e-5)
    assert got[1] < 1e-3
    assert got[2] == 0.0


def test_cpu_wrapper_uses_plain_and_counts_no_launch():
    rng = np.random.RandomState(4)
    c = torch.as_tensor(_corners(_rand_boxes5(rng, (2, 9))))
    before = rotated_overlap.LAUNCHES
    got = rotated_overlap.pair_overlap_batched(c[:, :3].contiguous(), c)
    assert rotated_overlap.LAUNCHES == before
    torch.testing.assert_close(
        got, rotated_overlap.pair_overlap_batched_plain(c[:, :3], c),
        rtol=0, atol=0)


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'groups', 'strides',
                                 'device'])
def test_wrapper_rejects_bad_input(bad):
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
        rotated_overlap.pair_overlap_batched(a, b)

