"""Point-cloud voxelizers: on the host for the data pipeline, on the
device for the raw-scan entry points.

* `VoxelGenerator`: the port's copy of `pcdet_tpu.ops.voxelizer.
  VoxelGenerator`, spconv's semantics on the host (csrc/
  voxelizer_native.cpp): points consumed in order, voxels in
  first-appearance order, capped at `max_voxels`, points per voxel at
  `max_num_points`, coordinates ZYX.  Past the cap it keeps the voxels that
  appear first, so the data pipeline trains on `pcdet_tpu`'s voxels.
* `voxelize_torch`: `pcdet_tpu.ops.voxelizer.voxelize_jnp` on tensors with
  the batch dimension written out: a stable sort by linear voxel id,
  segment ranks from a cumsum and a cummax, and scatters into buffers with
  one extra drop row that is sliced off afterwards (JAX's `mode='drop'`).
  Voxels come out ordered by linear voxel id, and past the cap it keeps the
  lowest ids.  All six outputs are bit-identical to `voxelize_jnp`.
"""
import numpy as np
import torch

from . import host_native


class VoxelGenerator:
    def __init__(self, voxel_size, point_cloud_range, max_num_points,
                 max_voxels=20000):
        self.voxel_size = np.asarray(voxel_size, dtype=np.float32)
        self.point_cloud_range = np.asarray(point_cloud_range,
                                            dtype=np.float32)
        grid = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) \
            / self.voxel_size
        self.grid_size = np.round(grid).astype(np.int64)
        self.max_num_points = int(max_num_points)
        self.max_voxels = int(max_voxels)

    def generate(self, points, pad_to_max=False):
        """Voxelize `points` (P, C); xyz must be the first 3 channels.

        :return: dict voxels (N, max_num_points, C) f32, coordinates (N, 3)
            int32 ZYX, num_points_per_voxel (N,) int32,
            voxel_pt_indices_into_original_pt_cloud (N, max_num_points)
            int64 (-1 pad), num_voxels; N = num_voxels, or max_voxels when
            pad_to_max
        """
        points = np.asarray(points)
        out = host_native.voxelize(points.astype(np.float32, copy=False),
                                   self.voxel_size,
                                   self.point_cloud_range[:3],
                                   self.grid_size, self.max_num_points,
                                   self.max_voxels)
        if not pad_to_max:
            n = out['num_voxels']
            out = {k: (v[:n] if isinstance(v, np.ndarray) else v)
                   for k, v in out.items()}
        return out


def grid_size(voxel_size, point_cloud_range):
    """[nx, ny, nz] as voxelize_jnp computes it, in float32."""
    vs = np.asarray(voxel_size, np.float32)
    pr = np.asarray(point_cloud_range, np.float32)
    return [int(v) for v in np.round((pr[3:6] - pr[0:3]) / vs)]


def voxelize_torch(points, point_mask, voxel_size, point_cloud_range,
                   max_num_points, max_voxels):
    """
    :param points: (B, P, C) f32, padded
    :param point_mask: (B, P) bool, True for real points
    :return: dict of fixed-shape tensors:
        voxels (B, max_voxels, max_num_points, C),
        coordinates (B, max_voxels, 3) int32 ZYX (-1 rows for empty),
        num_points_per_voxel (B, max_voxels) int32,
        voxel_mask (B, max_voxels) bool,
        point_voxel_idx (B, P) int32, voxel row of each point (-1 = dropped),
        voxel_pt_indices_into_original_pt_cloud (B, max_voxels,
            max_num_points) int32, gather map, -1 pad,
        voxel_overflow (B,) int32, occupied in-range voxels past the cap
            (the JAX loader's `voxel_overflow` telemetry).
    """
    dev = points.device
    b, p, c = points.shape
    nx, ny, nz = grid_size(voxel_size, point_cloud_range)
    vsize = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    lo = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    grid = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)

    coords = torch.floor((points[..., :3] - lo) / vsize).to(torch.int32)
    in_range = ((coords >= 0) & (coords < grid)).all(dim=-1) & point_mask
    lin = (coords[..., 2] * ny + coords[..., 1]) * nx + coords[..., 0]
    big = nx * ny * nz
    lin = torch.where(in_range, lin, big)

    # stable sort keeps the original point order inside each voxel
    lin_s, sort_idx = torch.sort(lin, dim=1, stable=True)
    pts_s = torch.gather(points, 1, sort_idx[..., None].expand(b, p, c))
    valid_s = lin_s < big

    first = torch.cat([valid_s[:, :1],
                       (lin_s[:, 1:] != lin_s[:, :-1]) & valid_s[:, 1:]], dim=1)
    voxel_rank = torch.cumsum(first.to(torch.int32), dim=1,
                              dtype=torch.int32) - 1
    pos = torch.arange(p, dtype=torch.int32, device=dev)[None].expand(b, p)
    seg_start = torch.cummax(torch.where(first, pos, 0), dim=1).values
    slot = pos - seg_start

    ok = valid_s & (voxel_rank < max_voxels) & (slot < max_num_points)
    # rows of all samples flattened, plus ONE drop row at the end, so that
    # the outputs are contiguous views once the drop row is sliced off
    rows = b * max_voxels
    row0 = torch.arange(b, device=dev)[:, None] * max_voxels
    v_flat = torch.where(ok, row0 + voxel_rank, rows)
    s_safe = torch.where(ok, slot, 0).long()

    voxels = torch.zeros((rows + 1, max_num_points, c), dtype=points.dtype,
                         device=dev)
    voxels[v_flat, s_safe] = pts_s
    pt_indices = torch.full((rows + 1, max_num_points), -1, dtype=torch.int32,
                            device=dev)
    pt_indices[v_flat, s_safe] = sort_idx.to(torch.int32)
    num_points = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
    num_points.index_add_(0, v_flat.flatten(), ok.to(torch.int32).flatten())

    # cell coords recomputed from the sorted points: the same floor formula
    # on the same f32 values as gathering coords by sort_idx
    coords_s = torch.floor((pts_s[..., :3] - lo) / vsize).to(torch.int32)
    zyx = torch.stack([coords_s[..., 2], coords_s[..., 1], coords_s[..., 0]],
                      dim=-1)
    first_ok = first & (voxel_rank < max_voxels)
    v_first = torch.where(first_ok, row0 + voxel_rank, rows)
    coord_rows = torch.full((rows + 1, 3), -1, dtype=torch.int32, device=dev)
    coord_rows[v_first] = zyx
    coord_rows = coord_rows[:rows].view(b, max_voxels, 3)

    pvi_sorted = torch.where(ok, voxel_rank, -1)
    point_voxel_idx = torch.zeros((b, p), dtype=torch.int32,
                                  device=dev).scatter_(1, sort_idx, pvi_sorted)

    return {
        'voxels': voxels[:rows].view(b, max_voxels, max_num_points, c),
        'coordinates': coord_rows,
        'num_points_per_voxel': num_points[:rows].view(b, max_voxels),
        'voxel_mask': coord_rows[..., 0] >= 0,
        'point_voxel_idx': point_voxel_idx,
        'voxel_pt_indices_into_original_pt_cloud':
            pt_indices[:rows].view(b, max_voxels, max_num_points),
        'voxel_overflow': torch.clamp(
            first.sum(dim=1, dtype=torch.int32) - max_voxels, min=0),
    }
