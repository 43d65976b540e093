"""Rotated BEV box overlap and IoU on tensors.

Twin of `pcdet_tpu.ops.rotated_iou`: the edge-clip formulation (the plain
version of kernel A, `csrc/rotated_overlap.cu`), the 24-candidate sort
formulation `quad_intersection_area_sort` (the independent formulation kernel
A″'s plain version is held against), and the 3D IoU of the recall counters,
whose BEV overlaps are one launch of kernel A for a batch on the card.

Box format: (N, 5) = [x1, y1, x2, y2, angle], the axis-aligned extent before
rotating by `angle` about the box center.  Intersection areas come from
Green's theorem: area(A∩B) = Σ_{e∈∂A} ∫_{e∩B} x dy + Σ_{e∈∂B} ∫_{e∩A} x dy,
where each edge is clipped to a parameter interval against the partner's
four half-planes.

`_edge_clip_contrib` accumulates the four edges one after another, in the
order of the kernel's loop, with one tensor op per kernel operation: built
with `--fmad=false`, the kernel then rounds every multiply and add as this
version does.
"""
import torch

from ..utils import torch_common


def boxes5_to_corners(boxes):
    """(..., 5)[x1,y1,x2,y2,angle] -> (..., 4, 2) corners (CCW winding)."""
    x1, y1, x2, y2, ang = [boxes[..., i] for i in range(5)]
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    hx, hy = (x2 - x1) / 2, (y2 - y1) / 2
    # the signs [1, -1, -1, 1] and [1, 1, -1, -1], made on the boxes' device
    # (a tensor from a list would be a blocking copy from the host)
    k = torch.arange(4, device=boxes.device)
    sx = torch.where(k % 3 == 0, 1.0, -1.0).to(boxes.dtype)
    sy = torch.where(k < 2, 1.0, -1.0).to(boxes.dtype)
    ox = hx[..., None] * sx
    oy = hy[..., None] * sy
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    px = ox * c + oy * s + cx[..., None]
    py = -ox * s + oy * c + cy[..., None]
    return torch.stack([px, py], dim=-1)


def _cross(o, a, b):
    """2D cross of (a - o) x (b - o); broadcasting over leading dims."""
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (b[..., 0] - o[..., 0]) * (a[..., 1] - o[..., 1]))


def _points_in_quad(points, quad):
    """points (..., P, 2) inside convex CCW quad (..., 4, 2) -> (..., P) bool."""
    eps = 1e-6
    inside = None
    for i in range(4):
        v0 = quad[..., i, :][..., None, :]
        v1 = quad[..., (i + 1) % 4, :][..., None, :]
        cond = _cross(v0, v1, points) >= -eps
        inside = cond if inside is None else (inside & cond)
    return inside


def _segment_intersections(ca, cb):
    """All 16 edge-pair intersections of two quads (..., 4, 2) ->
    points (..., 16, 2), valid (..., 16)."""
    p0 = ca
    p1 = torch.roll(ca, -1, dims=-2)
    q0 = cb
    q1 = torch.roll(cb, -1, dims=-2)
    p0g = p0[..., :, None, :]                   # pair grid (..., 4, 4, 2)
    p1g = p1[..., :, None, :]
    q0g = q0[..., None, :, :]
    q1g = q1[..., None, :, :]
    r = p1g - p0g
    s = q1g - q0g
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q0g - p0g
    t_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    u_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    eps = 1e-8
    safe = torch.where(torch.abs(denom) > eps, denom, 1.0)
    t = t_num / safe
    u = u_num / safe
    valid = ((torch.abs(denom) > eps) & (t >= 0) & (t <= 1) & (u >= 0)
             & (u <= 1))
    pt = p0g + t[..., None] * r
    batch_shape = pt.shape[:-3]
    return (pt.reshape(*batch_shape, 16, 2),
            valid.reshape(*batch_shape, 16))


def quad_intersection_area_sort(ca, cb):
    """Intersection area of convex CCW quads given corners (..., 4, 2) by
    the 24-candidate formulation: candidates with validity masks, sorted by
    angle around the valid centroid (stable, invalid last), shoelace.
    The independent formulation kernel A″'s plain version is tested
    against; nothing on the port's paths calls it."""
    shape = torch.broadcast_shapes(ca.shape, cb.shape)
    ca = ca.expand(shape)
    cb = cb.expand(shape)
    in_b = _points_in_quad(ca, cb)                  # (..., 4)
    in_a = _points_in_quad(cb, ca)                  # (..., 4)
    ipts, ivalid = _segment_intersections(ca, cb)   # (..., 16, 2/16)

    pts = torch.cat([ca, cb, ipts], dim=-2)                     # (..., 24, 2)
    valid = torch.cat([in_b, in_a, ivalid], dim=-1)             # (..., 24)

    vf = valid.to(pts.dtype)
    count = torch.sum(vf, dim=-1, keepdim=True)                 # (..., 1)
    centroid = (torch.sum(pts * vf[..., None], dim=-2)
                / torch.clamp(count, min=1.0))                  # (..., 2)

    ang = torch.atan2(pts[..., 1] - centroid[..., None, 1],
                      pts[..., 0] - centroid[..., None, 0])
    ang = torch.where(valid, ang, torch.inf)                    # invalid last
    order = torch.argsort(ang, dim=-1, stable=True)
    pts_sorted = torch.gather(pts, -2,
                              order[..., None].expand(*order.shape, 2))
    valid_sorted = torch.gather(valid, -1, order)
    # invalid slots parked on the first vertex, so the wrap-around term
    # appears once and the degenerate edges add nothing
    first = pts_sorted[..., 0:1, :]
    pts_fixed = torch.where(valid_sorted[..., None], pts_sorted, first)

    nxt = torch.roll(pts_fixed, -1, dims=-2)
    area2 = torch.sum(pts_fixed[..., 0] * nxt[..., 1]
                      - nxt[..., 0] * pts_fixed[..., 1], dim=-1)
    area = 0.5 * torch.abs(area2)
    return torch.where(count[..., 0] >= 3, area, 0.0)


def _edge_clip_contrib(p, q, eps_side):
    """Green's-theorem contribution of polygon `p`'s edges restricted to the
    interior of the convex CCW quad `q`.

    `eps_side` sets the boundary convention: +eps counts an edge lying on
    q's boundary as inside, -eps excludes it.  Used with opposite signs for
    the two polygons so that a shared boundary is traversed exactly once.

    :param p: (..., 4, 2) CCW corners; :param q: (..., 4, 2) CCW corners
    :return: (acc, narc): (...,) signed area contribution and number of
        live arcs
    """
    tiny = 1e-12
    px, py = p[..., 0], p[..., 1]
    qx, qy = q[..., 0], q[..., 1]
    acc = torch.zeros_like(px[..., 0])
    narc = torch.zeros_like(acc)
    for i in range(4):
        p0x = px[..., i]
        p0y = py[..., i]
        dx = px[..., (i + 1) % 4] - px[..., i]
        dy = py[..., (i + 1) % 4] - py[..., i]
        s_lo = torch.zeros_like(acc)
        s_hi = torch.ones_like(acc)
        ok = torch.ones_like(acc, dtype=torch.bool)
        for j in range(4):
            ex = qx[..., (j + 1) % 4] - qx[..., j]
            ey = qy[..., (j + 1) % 4] - qy[..., j]
            f0 = ex * (p0y - qy[..., j]) - ey * (p0x - qx[..., j])
            fd = ex * dy - ey * dx
            is_par = torch.abs(fd) <= tiny
            bound = (-eps_side - f0) / torch.where(is_par, 1.0, fd)
            s_lo = torch.where(fd > tiny, torch.maximum(s_lo, bound), s_lo)
            s_hi = torch.where(fd < -tiny, torch.minimum(s_hi, bound), s_hi)
            ok = ok & (~is_par | (f0 >= -eps_side))
        s_lo = torch.clamp(s_lo, 0.0, 1.0)
        s_hi = torch.clamp(s_hi, 0.0, 1.0)
        ds = torch.clamp(s_hi - s_lo, min=0.0)
        live = ok & (ds > 1e-6)
        integral = dy * (p0x * ds + 0.5 * dx * (s_hi + s_lo) * ds)
        acc = acc + torch.where(live, integral, 0.0)
        narc = narc + torch.where(live, 1.0, 0.0)
    return acc, narc


def quad_intersection_area(ca, cb, eps=1e-7):
    """Intersection area of convex CCW quads given corners (..., 4, 2),
    broadcasting over the leading dims."""
    shape = torch.broadcast_shapes(ca.shape, cb.shape)
    ca = ca.expand(shape)
    cb = cb.expand(shape)
    a1, n1 = _edge_clip_contrib(ca, cb, eps)
    a2, n2 = _edge_clip_contrib(cb, ca, -eps)
    # a nonempty 2D intersection has >= 3 boundary arcs; fewer arcs means a
    # degenerate touching (open traversal, bogus area)
    return torch.where(n1 + n2 >= 3.0, torch.clamp(a1 + a2, min=0.0), 0.0)


def boxes_overlap_bev(boxes_a, boxes_b):
    """(N,5) x (K,5) -> (N,K) rotated intersection areas."""
    ca = boxes5_to_corners(boxes_a)
    cb = boxes5_to_corners(boxes_b)
    return quad_intersection_area(ca[:, None], cb[None, :])


def boxes_iou_bev(boxes_a, boxes_b):
    """(N,5) x (K,5) -> (N,K) rotated BEV IoU."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = ((boxes_a[:, 2] - boxes_a[:, 0])
              * (boxes_a[:, 3] - boxes_a[:, 1]))[:, None]
    area_b = ((boxes_b[:, 2] - boxes_b[:, 0])
              * (boxes_b[:, 3] - boxes_b[:, 1]))[None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=1e-8)


def boxes7_to_corners(boxes):
    """(..., 7) lidar boxes [x,y,z,w,l,h,ry] -> (..., 4, 2) contiguous BEV
    corners (CCW), the overlap kernels' operand."""
    return boxes5_to_corners(
        torch_common.boxes3d_to_bev_corner_format(boxes)).contiguous()


def boxes_iou3d_batched(boxes_a, boxes_b, overlap_fn=None):
    """3D IoU of (B, N, 7) x (B, K, 7) lidar boxes [x,y,z,w,l,h,ry], z the
    bottom center -> (B, N, K): BEV rotated overlap x z-extent overlap over
    the union of volumes, floor 1e-6 (`pcdet_tpu.ops.rotated_iou.
    boxes_iou3d` per sample).

    :param overlap_fn: (B, N, 4, 2) x (B, K, 4, 2) corners -> (B, N, K)
        areas; default kernel A, `rotated_overlap.pair_overlap_batched`, one
        launch for the batch on the card, its plain version on the CPU
    """
    if overlap_fn is None:
        from .rotated_overlap import pair_overlap_batched   # imports us
        overlap_fn = pair_overlap_batched
    overlaps_bev = overlap_fn(boxes7_to_corners(boxes_a),
                              boxes7_to_corners(boxes_b))

    a_zmin, a_zmax = boxes_a[..., 2], boxes_a[..., 2] + boxes_a[..., 5]
    b_zmin, b_zmax = boxes_b[..., 2], boxes_b[..., 2] + boxes_b[..., 5]
    overlaps_h = torch.clamp(
        torch.minimum(a_zmax[..., :, None], b_zmax[..., None, :])
        - torch.maximum(a_zmin[..., :, None], b_zmin[..., None, :]), min=0)
    overlaps_3d = overlaps_bev * overlaps_h
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return overlaps_3d / torch.clamp(vol_a + vol_b - overlaps_3d, min=1e-6)


def boxes_iou3d(boxes_a, boxes_b):
    """(N, 7) x (K, 7) -> (N, K) 3D IoU: the one-sample case of
    `boxes_iou3d_batched`."""
    return boxes_iou3d_batched(boxes_a[None], boxes_b[None])[0]
