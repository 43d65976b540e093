"""Plain decode and greedy rotated NMS of one-stage head outputs.

Decode (PCDet's ResidualCoder with the direction classifier): x, y by the
anchor's BEV diagonal, z by its height (about the box centre), sizes by
exp, the heading snapped into the direction bin that the classifier
picks.  Selection: each anchor's best class logit ranks it, anchors whose
sigmoid is below SCORE_THRESH drop out, the top NMS_PRE_MAXSIZE_LAST go
into a greedy NMS (ties in rank by lower anchor index) that keeps a box
unless a kept box of higher rank overlaps it by a BEV IoU above
NMS_THRESH, at most NMS_POST_MAXSIZE_LAST kept.  The BEV IoU is the
rotated intersection over the sum of the two axis-aligned (w x l) areas
less the intersection.

The intersection below is a frozen copy of
pcdet_tpu_torch/ops/rotated_iou.py:25-126 (`boxes5_to_corners`, `_cross`,
`_points_in_quad`, `_segment_intersections`, `quad_intersection_area_sort`:
the 24-candidate formulation that nothing on the port's paths calls).
"""
import math

import numpy as np
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


def _cross(o, a, b):
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (b[..., 0] - o[..., 0]) * (a[..., 1] - o[..., 1]))


def _points_in_quad(points, quad):
    eps = 1e-6
    inside = None
    for i in range(4):
        v0 = quad[..., i, :][..., None, :]
        v1 = quad[..., (i + 1) % 4, :][..., None, :]
        cond = _cross(v0, v1, points) >= -eps
        inside = cond if inside is None else (inside & cond)
    return inside


def _segment_intersections(ca, cb):
    p0 = ca
    p1 = torch.roll(ca, -1, dims=-2)
    q0 = cb
    q1 = torch.roll(cb, -1, dims=-2)
    p0g = p0[..., :, None, :]
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
    shape = torch.broadcast_shapes(ca.shape, cb.shape)
    ca = ca.expand(shape)
    cb = cb.expand(shape)
    in_b = _points_in_quad(ca, cb)
    in_a = _points_in_quad(cb, ca)
    ipts, ivalid = _segment_intersections(ca, cb)
    pts = torch.cat([ca, cb, ipts], dim=-2)
    valid = torch.cat([in_b, in_a, ivalid], dim=-1)
    vf = valid.to(pts.dtype)
    count = torch.sum(vf, dim=-1, keepdim=True)
    centroid = (torch.sum(pts * vf[..., None], dim=-2)
                / torch.clamp(count, min=1.0))
    ang = torch.atan2(pts[..., 1] - centroid[..., None, 1],
                      pts[..., 0] - centroid[..., None, 0])
    ang = torch.where(valid, ang, torch.inf)
    order = torch.argsort(ang, dim=-1, stable=True)
    pts_sorted = torch.gather(pts, -2,
                              order[..., None].expand(*order.shape, 2))
    valid_sorted = torch.gather(valid, -1, order)
    first = pts_sorted[..., 0:1, :]
    pts_fixed = torch.where(valid_sorted[..., None], pts_sorted, first)
    nxt = torch.roll(pts_fixed, -1, dims=-2)
    area2 = torch.sum(pts_fixed[..., 0] * nxt[..., 1]
                      - nxt[..., 0] * pts_fixed[..., 1], dim=-1)
    area = 0.5 * torch.abs(area2)
    return torch.where(count[..., 0] >= 3, area, 0.0)


def decode(box, anchors, dirp, args):
    """(..., A, 7) codes, (A, 7) anchors, (..., A, 2) direction logits ->
    (..., A, 7) boxes."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = box.unbind(-1)
    za = za + ha / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    hg = torch.exp(ht) * ha
    rg = rt + ra
    off = float(args.get('dir_offset', 0.78539))
    lim = float(args.get('dir_limit_offset', 0.0))
    period = math.pi
    dir_rot = rg - off - torch.floor((rg - off) / period + lim) * period
    rot = dir_rot + off + period * torch.argmax(dirp, -1).to(box.dtype)
    return torch.stack([xt * diag + xa, yt * diag + ya, zt * ha + za - hg / 2,
                        torch.exp(wt) * wa, torch.exp(lt) * la, hg, rot], -1)


def bev_iou_pairs(boxes, i, j):
    """Rotated BEV IoU of the pairs (boxes[i], boxes[j]), boxes (N, 7)."""
    def five(b):
        return torch.stack([b[:, 0] - b[:, 3] / 2, b[:, 1] - b[:, 4] / 2,
                            b[:, 0] + b[:, 3] / 2, b[:, 1] + b[:, 4] / 2,
                            b[:, 6]], -1)
    a5, b5 = five(boxes[i]), five(boxes[j])
    inter = quad_intersection_area_sort(boxes5_to_corners(a5),
                                        boxes5_to_corners(b5))
    area_a = boxes[i, 3] * boxes[i, 4]
    area_b = boxes[j, 3] * boxes[j, 4]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-8)


def greedy_nms(boxes, thresh, post_max, chunk=1 << 20):
    """Indices kept by greedy NMS of boxes (N, 7) already in rank order.
    Only pairs whose bounding circles meet are clipped."""
    n = boxes.shape[0]
    if n == 0:
        return []
    r = 0.5 * torch.sqrt(boxes[:, 3] ** 2 + boxes[:, 4] ** 2)
    ii, jj = torch.triu_indices(n, n, 1, device=boxes.device)
    pairs_i, pairs_j = [], []
    for s in range(0, len(ii), chunk):
        a, b = ii[s:s + chunk], jj[s:s + chunk]
        d = torch.hypot(boxes[a, 0] - boxes[b, 0], boxes[a, 1] - boxes[b, 1])
        near = d <= r[a] + r[b]
        pairs_i.append(a[near])
        pairs_j.append(b[near])
    a, b = torch.cat(pairs_i), torch.cat(pairs_j)
    over = torch.zeros(0, dtype=torch.bool, device=boxes.device)
    parts = [bev_iou_pairs(boxes, a[s:s + chunk], b[s:s + chunk]) > thresh
             for s in range(0, len(a), chunk)]
    if parts:
        over = torch.cat(parts)
    a, b = a[over].cpu().numpy(), b[over].cpu().numpy()
    order = np.argsort(a, kind='stable')
    a, b = a[order], b[order]
    starts = np.searchsorted(a, np.arange(n + 1))
    suppressed = np.zeros(n, bool)
    kept = []
    for k in range(n):
        if suppressed[k]:
            continue
        kept.append(k)
        if len(kept) == post_max:
            break
        suppressed[b[starts[k]:starts[k + 1]]] = True
    return kept


def detections(out, anchors, cfg):
    """Per scan: dict boxes (K, 7), scores (K,) raw logits, labels (K,)
    1..C, anchor (K,) indices of the kept boxes, and every anchor's box
    (A, 7) and logits (A, C)."""
    args = cfg['MODEL']['RPN']['RPN_HEAD']['ARGS']
    tc = cfg['MODEL']['TEST']
    thresh = float(tc['SCORE_THRESH'])
    pre = int(tc['NMS_PRE_MAXSIZE_LAST'])
    post = int(tc['NMS_POST_MAXSIZE_LAST'])
    res = []
    for b in range(out['cls'].shape[0]):
        cls = out['cls'][b].float()
        boxes = decode(out['box'][b].float(), anchors, out['dir'][b].float(),
                       args)
        rank, label = cls.max(-1)
        ranked = torch.where(torch.sigmoid(rank) >= thresh, rank, -math.inf)
        _, order = torch.sort(ranked, descending=True, stable=True)
        order = order[:pre]
        order = order[torch.isfinite(ranked[order])]
        kept = order[greedy_nms(boxes[order], float(tc['NMS_THRESH']), post)]
        res.append({'boxes': boxes[kept], 'scores': rank[kept],
                    'labels': label[kept] + 1, 'anchor': kept,
                    'all_boxes': boxes,
                    'all_logits': cls})
    return res
