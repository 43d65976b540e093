"""pcdet_tpu_torch batched NMS vs pcdet_tpu.ops.nms.nms_bev_batched (CPU).

Indices and counts must be EXACTLY equal: greedy NMS is exact on both sides
(the port at block 64, JAX's CPU path at block 1 — the greedy result does
not depend on the block), and the IoUs agree to the last bits (see
test_torch_port_overlap.py), far from any threshold decision on these
random inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdet_tpu.ops import nms as jax_nms
from pcdet_tpu_torch.ops import nms

torch.set_num_threads(1)


def _boxes5(rng, n, spread):
    cx = rng.uniform(-spread, spread, n)
    cy = rng.uniform(-spread, spread, n)
    w = rng.uniform(1.0, 5.0, n)
    l = rng.uniform(1.0, 7.0, n)
    ang = rng.uniform(-np.pi, np.pi, n)
    return np.stack([cx - w / 2, cy - l / 2, cx + w / 2, cy + l / 2, ang],
                    axis=1).astype(np.float32)


def _both(boxes, scores, valid, thresh, pre, post, rotated):
    sel_j, num_j = jax_nms.nms_bev_batched(
        jnp.asarray(boxes), jnp.asarray(scores), thresh, pre_max=pre,
        post_max=post, valid_mask=jnp.asarray(valid), rotated=rotated)
    sel_t, num_t = nms.nms_bev_batched(
        torch.as_tensor(boxes), torch.as_tensor(scores), thresh, pre_max=pre,
        post_max=post, valid_mask=torch.as_tensor(valid), rotated=rotated)
    assert sel_t.dtype == torch.int32 and num_t.dtype == torch.int32
    return (np.asarray(sel_j), np.asarray(num_j)), (sel_t.numpy(),
                                                    num_t.numpy())


@pytest.mark.parametrize('rotated', [True, False])
@pytest.mark.parametrize('spread,thresh', [(15.0, 0.1), (40.0, 0.01)])
def test_matches_jax_exactly(rotated, spread, thresh):
    rng = np.random.RandomState(0)
    g, a, pre, post = 4, 300, 160, 48
    boxes = np.stack([_boxes5(rng, a, spread) for _ in range(g)])
    scores = rng.randn(g, a).astype(np.float32)
    valid = rng.rand(g, a) > 0.2
    valid[2] = False                                  # an empty sample
    (sj, nj), (st, nt) = _both(boxes, scores, valid, thresh, pre, post,
                               rotated)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(nt, nj)
    assert nt[2] == 0 and (st[2] == -1).all()
    assert (nt[[0, 1, 3]] > 0).all()


@pytest.mark.parametrize('rotated', [True, False])
def test_post_max_truncation(rotated):
    # a dense cluster: long suppression chains, and blocks whose keepers
    # overshoot post_max (the port keeps 64-box blocks, JAX on CPU 1)
    rng = np.random.RandomState(1)
    g, a, post = 3, 200, 8
    boxes = np.stack([_boxes5(rng, a, 6.0) for _ in range(g)])
    scores = rng.randn(g, a).astype(np.float32)
    valid = np.ones((g, a), bool)
    (sj, nj), (st, nt) = _both(boxes, scores, valid, 0.3, 200, post, rotated)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(nt, nj)
    assert (nt == post).all()


def test_pre_max_below_post_max_pads():
    rng = np.random.RandomState(2)
    boxes = _boxes5(rng, 20, 30.0)[None]
    scores = rng.randn(1, 20).astype(np.float32)
    (sj, nj), (st, nt) = _both(boxes, scores, np.ones((1, 20), bool), 0.1,
                               4096, 32, True)
    assert st.shape == (1, 32)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(nt, nj)


def test_topk_ties_break_by_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 1.0]])
    vals, idx = nms.topk_stable(x, 4)
    assert idx.tolist() == [[1, 2, 4, 0]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0]]
    import jax
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert np.asarray(ji).tolist() == idx.tolist()


def test_tied_scores_match_jax():
    # equal logits (empty BEV regions) must rank identically
    rng = np.random.RandomState(3)
    g, a = 2, 256
    boxes = np.stack([_boxes5(rng, a, 20.0) for _ in range(g)])
    scores = np.round(rng.randn(g, a), 1).astype(np.float32)
    (sj, nj), (st, nt) = _both(boxes, scores, np.ones((g, a), bool), 0.2,
                               100, 40, True)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(nt, nj)
