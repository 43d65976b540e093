"""Plain voxelization of padded scans, one scan at a time.

A point belongs to voxel floor((p - range_lo) / voxel_size) when that lies
inside the grid.  Voxels are kept in ascending linear id (z, y, x with x
fastest) up to `max_voxels` a scan, and each keeps its first
`max_points` points in the scan's own order (spconv's semantics with the
lowest ids kept past the cap, as the port states them).
"""
import numpy as np
import torch


def grid_size(voxel_size, pc_range):
    """[nx, ny, nz] of the grid, computed in float32."""
    vs = np.asarray(voxel_size, np.float32)
    pr = np.asarray(pc_range, np.float32)
    return [int(v) for v in np.round((pr[3:6] - pr[0:3]) / vs)]


def voxelize(points, mask, voxel_size, pc_range, max_points, max_voxels):
    """
    :param points: (B, P, 4) f32 tensor; :param mask: (B, P) bool
    :return: dict coords (N, 4) int64 [b, z, y, x] sorted by scan then
        linear id, points (N, max_points, 4) zero padded, num (N,) int64,
        dropped (B,) occupied voxels past the cap
    """
    dev = points.device
    nx, ny, nz = grid_size(voxel_size, pc_range)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    hi = torch.tensor([nx, ny, nz], device=dev)
    out_c, out_p, out_n, dropped = [], [], [], []
    for b in range(points.shape[0]):
        pts = points[b][mask[b]]
        c = torch.floor((pts[:, :3] - lo) / vs).long()
        ok = ((c >= 0) & (c < hi)).all(dim=1)
        pts, c = pts[ok], c[ok]
        lin = (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]
        order = torch.argsort(lin, stable=True)
        lin, pts, c = lin[order], pts[order], c[order]
        uniq, inverse, counts = torch.unique_consecutive(
            lin, return_inverse=True, return_counts=True)
        dropped.append(max(len(uniq) - max_voxels, 0))
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(len(lin), device=dev) - starts[inverse]
        keep = (inverse < max_voxels) & (slot < max_points)
        n_vox = min(len(uniq), max_voxels)
        vox = torch.zeros((n_vox, max_points, 4), dtype=points.dtype,
                          device=dev)
        vox[inverse[keep], slot[keep]] = pts[keep]
        first = starts[:n_vox]
        zyx = c[first][:, [2, 1, 0]]
        out_c.append(torch.cat([torch.full((n_vox, 1), b, device=dev,
                                           dtype=torch.long), zyx], 1))
        out_p.append(vox)
        out_n.append(torch.clamp(counts[:n_vox], max=max_points))
    return {'coords': torch.cat(out_c), 'points': torch.cat(out_p),
            'num': torch.cat(out_n), 'dropped': dropped}
