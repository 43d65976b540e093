"""Rotated BEV box overlap and IoU on tensors.

Twin of `pcdet_tpu.ops.rotated_iou` (edge-clip formulation) and the plain
version of the CUDA kernel in `csrc/rotated_overlap.cu`.

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


def boxes5_to_corners(boxes):
    """(..., 5)[x1,y1,x2,y2,angle] -> (..., 4, 2) corners (CCW winding)."""
    x1, y1, x2, y2, ang = [boxes[..., i] for i in range(5)]
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    hx, hy = (x2 - x1) / 2, (y2 - y1) / 2
    sx = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=boxes.dtype,
                      device=boxes.device)
    sy = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=boxes.dtype,
                      device=boxes.device)
    ox = hx[..., None] * sx
    oy = hy[..., None] * sy
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    px = ox * c + oy * s + cx[..., None]
    py = -ox * s + oy * c + cy[..., None]
    return torch.stack([px, py], dim=-1)


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
