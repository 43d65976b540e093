"""RoI-aware 3D pooling of per-voxel features into each RoI's grid.

Port of `pcdet_tpu.ops.roiaware_pool.roiaware_pool3d_multi_batched` (and
`_roi_local_cells`), the pool Part-A²'s RCNN reads.  XLA ops there, torch
ops here: no TPU kernel stands behind it.  Per RoI:

  1. the in-box test and cell of every point in the RoI's canonical frame;
  2. the first `max_pts_per_roi` in-box points by index, then a stable sort
     by cell, shared by every feature set;
  3. per feature set a segmented max or mean over each cell's run of the
     sorted list, by a log-depth segmented scan (no scatter, no float
     atomic: two calls give the same bits);
  4. the value at each run's end written once into its (RoI, cell) slot.

The mean sums in the scan's tree order, not JAX's, so it agrees to
rounding; the max is exact.  `points_in_boxes_batch` is the reference's
points_in_boxes op (`pcdet_tpu.ops.roiaware_pool.points_in_boxes_batch`).
"""
import torch

from ..utils.torch_common import points_in_boxes

INT_MAX = torch.iinfo(torch.int32).max


def roi_local_cells(rois, pts, out_size):
    """Canonical-frame cell index and in-box test of (..., N, K, 3) points
    against their (..., N, 7) RoIs, in `pcdet_tpu`'s op order.

    :return: cell (..., N, K) int32 as (x_idx * o + y_idx) * o + z_idx,
        in_box (..., N, K) bool
    """
    o = out_size
    shift = pts - rois[..., :, None, 0:3]
    cosa = torch.cos(-rois[..., :, 6])[..., :, None]
    sina = torch.sin(-rois[..., :, 6])[..., :, None]
    lx = shift[..., 0] * cosa + shift[..., 1] * sina
    ly = -shift[..., 0] * sina + shift[..., 1] * cosa
    lz = shift[..., 2]
    w, l, h = rois[..., :, 3:4], rois[..., :, 4:5], rois[..., :, 5:6]
    in_box = ((torch.abs(lx) <= w / 2) & (torch.abs(ly) <= l / 2)
              & (lz >= 0) & (lz <= h))
    eps = 1e-8
    xi = torch.clamp((lx + w / 2) / torch.clamp(w, min=eps) * o, 0,
                     o - 1).to(torch.int32)
    yi = torch.clamp((ly + l / 2) / torch.clamp(l, min=eps) * o, 0,
                     o - 1).to(torch.int32)
    zi = torch.clamp(lz / torch.clamp(h, min=eps) * o, 0,
                     o - 1).to(torch.int32)
    return (xi * o + yi) * o + zi, in_box


def segmented_scan(vals, new_seg, op):
    """Inclusive scan of `op` along dim 2 restarting where `new_seg` is
    set: (B, N, K, C) values, (B, N, K) flags.  Hillis-Steele doubling, so
    the sums' order is fixed by K alone."""
    flags = new_seg[..., None]
    k = vals.shape[2]
    d = 1
    while d < k:
        prev_v, prev_f = vals[:, :, :-d], flags[:, :, :-d]
        cur_v, cur_f = vals[:, :, d:], flags[:, :, d:]
        vals = torch.cat([vals[:, :, :d],
                          torch.where(cur_f, cur_v, op(prev_v, cur_v))], 2)
        flags = torch.cat([flags[:, :, :d], cur_f | prev_f], 2)
        d *= 2
    return vals


def roiaware_pool3d_multi_batched(rois, points, feature_specs, point_mask,
                                  out_size=14, max_pts_per_roi=512,
                                  return_overflow=False):
    """Pool several feature sets over the same RoIs and points in one pass.

    :param rois: (B, N, 7) [x, y, z, w, l, h, rz], z at the bottom centre
    :param points: (B, P, 3) point or voxel-centre coordinates
    :param feature_specs: [((B, P, C_i) features, 'avg' | 'max')]
    :param point_mask: (B, P) bool
    :param max_pts_per_roi: the first this many in-box points of a RoI by
        index are pooled (exact while no RoI holds more)
    :param return_overflow: also return the in-box points past that cap,
        summed over the batch (0-dim int32)
    :return: [(B, N, o, o, o, C_i)] grids, cells [x_idx, y_idx, z_idx]
        (+ the overflow)
    """
    b, n = rois.shape[0], rois.shape[1]
    o = out_size
    o3 = o ** 3
    p = points.shape[1]
    k = min(int(max_pts_per_roi), p)
    dev = points.device

    cell_all, in_box_all = roi_local_cells(rois, points[:, None, :, :], o)
    in_box_all = in_box_all & point_mask[:, None, :]

    # the first k in-box point indices per RoI, ascending
    rank = torch.where(in_box_all, torch.arange(p, dtype=torch.int32,
                                                device=dev), INT_MAX)
    topv, topi = torch.topk(rank, k, dim=2, largest=False, sorted=True)
    sel_valid = topv != INT_MAX
    sel = torch.where(sel_valid, topi, 0)                          # (B, N, k)
    # pads go to a sentinel cell, so they sort last and never write
    cell = torch.where(sel_valid, torch.gather(cell_all, 2, sel), o3)
    cell_s, order = torch.sort(cell, dim=2, stable=True)
    sel_s = torch.gather(sel, 2, order)

    change = cell_s[..., 1:] != cell_s[..., :-1]
    true1 = torch.ones((b, n, 1), dtype=torch.bool, device=dev)
    new_seg = torch.cat([true1, change], 2)
    is_end = torch.cat([change, true1], 2)
    slot = (torch.arange(b, device=dev)[:, None, None] * n
            + torch.arange(n, device=dev)[None, :, None])
    write = is_end & (cell_s < o3)
    flat = torch.where(write, slot * o3 + cell_s, b * n * o3).reshape(-1)

    cnt = None
    outs = []
    for features, method in feature_specs:
        c = features.shape[-1]
        vals = torch.gather(
            features, 1, sel_s.reshape(b, n * k, 1).expand(-1, -1, c).long()
        ).reshape(b, n, k, c)
        if method == 'max':
            red = segmented_scan(vals, new_seg, torch.maximum)
        elif method == 'avg':
            red = segmented_scan(vals, new_seg, torch.add)
            if cnt is None:
                cnt = segmented_scan(torch.ones_like(vals[..., :1]), new_seg,
                                     torch.add)
            red = red / torch.clamp(cnt, min=1.0)
        else:
            raise ValueError('pool method %r: want max or avg' % method)
        # one slot past the grids takes every non-end row; the grids' slots
        # are written once each
        out = features.new_zeros((b * n * o3 + 1, c))
        out[flat] = red.reshape(-1, c)
        outs.append(out[:-1].reshape(b, n, o, o, o, c))
    if return_overflow:
        n_in_box = in_box_all.sum(dim=2)
        return outs, torch.clamp(n_in_box - k, min=0).sum().to(torch.int32)
    return outs


def points_in_boxes_batch(points, boxes, point_mask=None):
    """(P, 3+) points x (N, 7) boxes -> (N, P) bool, each point in each box
    (`utils.torch_common.points_in_boxes`), masked by `point_mask` (P,)
    where given."""
    m = points_in_boxes(points, boxes)
    if point_mask is not None:
        m = m & point_mask[None, :]
    return m
