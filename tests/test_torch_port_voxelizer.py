"""pcdet_tpu_torch voxelize_torch vs pcdet_tpu voxelize_jnp (CPU).

All six outputs must be BIT-IDENTICAL: both sides run the same f32 floor
formula, the same stable sort and the same integer segment ranks, including
when points overflow a voxel and when voxels overflow max_voxels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdet_tpu.ops.voxelizer import voxelize_jnp
from pcdet_tpu_torch.ops.voxelizer import grid_size, voxelize_torch

torch.set_num_threads(1)

VOXEL_SIZE = (0.16, 0.16, 4.0)
PC_RANGE = (0, -39.68, -3, 69.12, 39.68, 1)
KEYS = ('voxels', 'coordinates', 'num_points_per_voxel', 'voxel_mask',
        'point_voxel_idx', 'voxel_pt_indices_into_original_pt_cloud')


def _scan(rng, p, n_real, hot_fraction=0.3):
    """Points over (and beyond) the range, a share of them packed into a
    few hot voxels so that slots overflow."""
    pts = np.stack([rng.uniform(-5, 75, p), rng.uniform(-45, 45, p),
                    rng.uniform(-4, 2, p), rng.uniform(0, 1, p)],
                   axis=1).astype(np.float32)
    hot = rng.rand(p) < hot_fraction
    # the first sits in a low voxel id, inside even a binding voxel cap
    centers = np.array([[10.05, -39.0], [20.1, -5.1], [33.3, 7.7]],
                       np.float32)
    pick = centers[rng.randint(0, 3, p)]
    pts[hot, :2] = pick[hot] + rng.uniform(-0.02, 0.02, (hot.sum(), 2))
    mask = np.zeros(p, bool)
    mask[:n_real] = True
    return pts, mask


def _run_both(points, mask, max_points, max_voxels):
    fn = jax.jit(jax.vmap(lambda p, m: voxelize_jnp(
        p, m, VOXEL_SIZE, PC_RANGE, max_points, max_voxels)))
    want = {k: np.asarray(v) for k, v in fn(jnp.asarray(points),
                                            jnp.asarray(mask)).items()}
    got = {k: v.numpy() for k, v in voxelize_torch(
        torch.as_tensor(points), torch.as_tensor(mask), VOXEL_SIZE, PC_RANGE,
        max_points, max_voxels).items()}
    return want, got


def test_grid_size():
    assert grid_size(VOXEL_SIZE, PC_RANGE) == [432, 496, 1]


@pytest.mark.parametrize('max_points,max_voxels', [
    (32, 4000),     # caps do not bind
    (4, 4000),      # point slots overflow in the hot voxels
    (8, 150),       # voxel cap binds too
])
def test_bit_identical_to_jax(max_points, max_voxels):
    rng = np.random.RandomState(0)
    scans = [_scan(rng, 3000, n) for n in (3000, 1700)]
    points = np.stack([s[0] for s in scans])
    mask = np.stack([s[1] for s in scans])
    want, got = _run_both(points, mask, max_points, max_voxels)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    nv = want['voxel_mask'].sum(1)
    if max_voxels == 150:
        assert (nv == 150).all()
    assert want['num_points_per_voxel'].max() == max_points
    assert (want['point_voxel_idx'] == -1).any()


def test_empty_scan():
    points = np.zeros((1, 64, 4), np.float32)
    want, got = _run_both(points, np.zeros((1, 64), bool), 8, 32)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not got['voxel_mask'].any()
