"""Box residual coder (SECOND encoding): encode and decode on tensors, encode
in numpy.

Twin of `pcdet_tpu.utils.box_coder.ResidualCoder`: `encode`, `decode` and
`decode_with_head_direction` of its jnp half run on the device (the RCNN
loss encodes its targets there); `encode_np` is its numpy encode, which
the host target assignment (`models/anchors.py`) calls.  Box layout (x, y, z, w, l, h, r [, extras])
with z at the bottom center.
"""
import math

import numpy as np
import torch

from . import torch_common


class ResidualCoder:
    def __init__(self, code_size=7):
        self.code_size = code_size

    @staticmethod
    def encode_np(boxes, anchors):
        """(N, 7+) gt boxes vs (N, 7+) anchors -> (N, 7+) regression
        targets, numpy."""
        box_ndim = anchors.shape[-1]
        xa, ya, za, wa, la, ha, ra = [anchors[..., i:i + 1] for i in range(7)]
        xg, yg, zg, wg, lg, hg, rg = [boxes[..., i:i + 1] for i in range(7)]
        cas = [anchors[..., i:i + 1] for i in range(7, box_ndim)]
        cgs = [boxes[..., i:i + 1] for i in range(7, box_ndim)]
        zg = zg + hg / 2
        za = za + ha / 2
        diagonal = np.sqrt(la ** 2 + wa ** 2)
        xt = (xg - xa) / diagonal
        yt = (yg - ya) / diagonal
        zt = (zg - za) / ha
        lt = np.log(lg / la)
        wt = np.log(wg / wa)
        ht = np.log(hg / ha)
        rt = rg - ra
        cts = [g - a for g, a in zip(cgs, cas)]
        return np.concatenate([xt, yt, zt, wt, lt, ht, rt, *cts], axis=-1)

    @staticmethod
    def encode(boxes, anchors):
        """(..., 7+) boxes vs (..., 7+) anchors -> (..., 7+) residuals
        (`encode_jnp`)."""
        xa, ya, za, wa, la, ha, ra = [anchors[..., i] for i in range(7)]
        xg, yg, zg, wg, lg, hg, rg = [boxes[..., i] for i in range(7)]
        zg = zg + hg / 2
        za = za + ha / 2
        diagonal = torch.sqrt(la ** 2 + wa ** 2)
        out = torch.stack([(xg - xa) / diagonal, (yg - ya) / diagonal,
                           (zg - za) / ha, torch.log(wg / wa),
                           torch.log(lg / la), torch.log(hg / ha), rg - ra],
                          dim=-1)
        if anchors.shape[-1] > 7:
            out = torch.cat([out, boxes[..., 7:] - anchors[..., 7:]], dim=-1)
        return out

    @staticmethod
    def decode(box_encodings, anchors):
        xa, ya, za, wa, la, ha, ra = [anchors[..., i] for i in range(7)]
        xt, yt, zt, wt, lt, ht, rt = [box_encodings[..., i] for i in range(7)]
        za = za + ha / 2
        diagonal = torch.sqrt(la ** 2 + wa ** 2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * ha + za
        lg = torch.exp(lt) * la
        wg = torch.exp(wt) * wa
        hg = torch.exp(ht) * ha
        rg = rt + ra
        zg = zg - hg / 2
        out = torch.stack([xg, yg, zg, wg, lg, hg, rg], dim=-1)
        if anchors.shape[-1] > 7:
            out = torch.cat([out, box_encodings[..., 7:] + anchors[..., 7:]],
                            dim=-1)
        return out

    def decode_with_head_direction(self, box_preds, anchors, dir_cls_preds,
                                   num_dir_bins, dir_offset, dir_limit_offset,
                                   use_binary_dir_classifier=False):
        """Decode and snap the heading into the direction classifier's bin.

        :param box_preds: (..., N, 7) encoded predictions
        :param anchors:   (..., N, 7)
        :param dir_cls_preds: (..., N, num_dir_bins) or None
        """
        boxes = self.decode(box_preds, anchors)
        if dir_cls_preds is None:
            return boxes
        dir_cls_preds = dir_cls_preds.reshape(*box_preds.shape[:-1], -1)
        dir_labels = torch.argmax(dir_cls_preds, dim=-1)
        if use_binary_dir_classifier:
            opp = (boxes[..., -1] > 0) ^ dir_labels.bool()
            rot = boxes[..., 6] + torch.where(opp, math.pi, 0.0)
        else:
            period = 2 * math.pi / num_dir_bins
            dir_rot = torch_common.limit_period(
                boxes[..., 6] - dir_offset, dir_limit_offset, period)
            rot = dir_rot + dir_offset + period * dir_labels.to(boxes.dtype)
        return torch.cat([boxes[..., :6], rot[..., None], boxes[..., 7:]],
                         dim=-1)
