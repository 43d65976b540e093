"""Anchors and anchor targets in numpy (float32), over the whole grid.

Anchors: per class one size and two rotations on a (ny, nx) grid of the
feature map (the voxel grid over DOWNSAMPLED_FACTOR), x and y centres on
`linspace` over the class's anchor range; flat order y, x, then the
classes' anchors in CLASS_NAMES order (the head's NHWC channel order).

Targets (SECOND's `nearest_iou_similarity`, no sampling): per class, the
IoU of the anchors' and the boxes' nearest axis-aligned BEV rectangles (a
box turned past 45 degrees swaps its width and length); each box's best
anchors (all ties, where that IoU is > 0) and every anchor at or above the
matched threshold are positive with the box's class, anchors below the
unmatched threshold are background (0), the rest -1; positives regress to
their best box by the residual code.
"""
import numpy as np


def _limit_period(val, offset, period):
    return val - np.floor(val / period + offset) * period


def class_anchors(gen, ny, nx):
    """(ny, nx, 2, 7) anchors of one class: [x, y, z, w, l, h, ry]."""
    r = np.asarray(gen['anchor_range'], np.float32)
    ys = np.linspace(r[1], r[4], ny, dtype=np.float32)
    xs = np.linspace(r[0], r[3], nx, dtype=np.float32)
    z = np.linspace(r[2], r[5], 1, dtype=np.float32)[0]
    w, l, h = np.asarray(gen['sizes'], np.float32).reshape(-1, 3)[0]
    rots = np.asarray(gen['rotations'], np.float32)
    out = np.zeros((ny, nx, len(rots), 7), np.float32)
    out[..., 0] = xs[None, :, None]
    out[..., 1] = ys[:, None, None]
    out[..., 2] = z
    out[..., 3], out[..., 4], out[..., 5] = w, l, h
    out[..., 6] = rots[None, None, :]
    return out


class Anchors:
    def __init__(self, cfg, grid):
        """:param grid: [nx, ny, nz] of the voxel grid"""
        tc = cfg['MODEL']['RPN']['RPN_HEAD']['TARGET_CONFIG']
        f = int(tc['DOWNSAMPLED_FACTOR'])
        self.ny, self.nx = grid[1] // f, grid[0] // f
        self.names = list(cfg['CLASS_NAMES'])
        gens = {g['class_name']: g for g in tc['ANCHOR_GENERATOR']}
        self.gens = [gens[n] for n in self.names]
        per = [class_anchors(g, self.ny, self.nx) for g in self.gens]
        self.per_class = per
        self.anchors = np.concatenate(per, axis=2).reshape(-1, 7)
        self.nloc = sum(a.shape[2] for a in per)

    def near_bbox(self, boxes):
        """(N, 7) -> (N, 4) nearest axis-aligned [x1, y1, x2, y2]."""
        rot = np.abs(_limit_period(boxes[:, 6], 0.5, np.pi))
        swap = (rot > np.pi / 4)[:, None]
        wl = np.where(swap, boxes[:, [4, 3]], boxes[:, [3, 4]])
        c = boxes[:, :2]
        return np.concatenate([c - wl / 2, c + wl / 2], 1).astype(np.float32)

    @staticmethod
    def iou(a, b):
        """Axis-aligned IoU (N, 4) x (M, 4) -> (N, M) float32."""
        area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
        area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        iw = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2])
                        - np.maximum(a[:, None, 0], b[None, :, 0]), 0)
        ih = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3])
                        - np.maximum(a[:, None, 1], b[None, :, 1]), 0)
        inter = iw * ih
        union = area_a[:, None] + area_b[None, :] - inter
        with np.errstate(divide='ignore', invalid='ignore'):
            return np.where(inter > 0, inter / union, 0).astype(np.float32)

    @staticmethod
    def encode(boxes, anchors):
        """Residual code of boxes against anchors, (N, 7)."""
        xa, ya, za, wa, la, ha, ra = anchors.T
        xg, yg, zg, wg, lg, hg, rg = boxes.T
        zg = zg + hg / 2
        za = za + ha / 2
        diag = np.sqrt(la ** 2 + wa ** 2)
        return np.stack([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha,
                         np.log(wg / wa), np.log(lg / la), np.log(hg / ha),
                         rg - ra], 1).astype(np.float32)

    def targets(self, gt):
        """(M, 8) boxes with class ids (zero rows = padding) -> labels (A,)
        int32 and reg targets (A, 7) float32."""
        gt = gt[np.abs(gt).sum(1) > 0]
        labels, regs = [], []
        for k, (g, a) in enumerate(zip(self.gens, self.per_class)):
            flat = a.reshape(-1, 7)
            boxes = gt[gt[:, 7] == k + 1][:, :7].astype(np.float32)
            lab = np.zeros(len(flat), np.int32)
            reg = np.zeros((len(flat), 7), np.float32)
            if len(boxes):
                ov = self.iou(self.near_bbox(flat), self.near_bbox(boxes))
                best = ov.argmax(1)
                best_ov = ov[np.arange(len(flat)), best]
                gt_max = ov.max(0)
                gt_max[gt_max == 0] = -1
                forced = np.where(ov == gt_max[None])[0]
                lab[:] = -1
                lab[best_ov < g['unmatched_threshold']] = 0
                pos = best_ov >= g['matched_threshold']
                lab[pos] = k + 1
                lab[forced] = k + 1
                fg = lab > 0
                reg[fg] = self.encode(boxes[best[fg]], flat[fg])
            labels.append(lab.reshape(self.ny, self.nx, -1))
            regs.append(reg.reshape(self.ny, self.nx, -1, 7))
        return (np.concatenate(labels, 2).reshape(-1),
                np.concatenate(regs, 2).reshape(-1, 7))
