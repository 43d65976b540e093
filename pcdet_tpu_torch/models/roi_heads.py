"""Part-A²'s second stage for serving: the proposal layer, the RCNN heads
over the pooled RoI grids, and the refined boxes' decode.

Twin of `pcdet_tpu.models.roi_heads` (`proposal_layer`,
`proposal_layer_from_head`, `MaskedConv3dBNReLU`, `FCBlock`,
`SpConvRCNNModule`, `FCRCNNModule`, `decode_rcnn_boxes`).  The proposal
NMS runs through `ops/nms.py`, whose rotated IoU rows are kernel A.  The
RCNN's sparse convs over the 14³ (12³) RoI grids are dense 3-D convs with
the inactive cells zero and the outputs masked to the active ones, as in
`pcdet_tpu`; they stay `torch.nn.functional.conv3d`.  Module names follow
the reference's partA2_rcnn_net.py (`rcnn_net.conv_part.0.0.weight`,
`rcnn_net.shared_fc_layer.{i}.conv.weight`, `...bn.bn.*`; dropouts keep
their Sequential indices), as `pcdet_tpu.train.torch_import.map_rcnn`
reads them; the dense conv weights keep spconv's (k, k, k, Cin, Cout)
layout.  The first shared FC reads the grid flattened channel-major, the
reference's order.  Dropout is off in eval.  The stage-2 training pieces
(`proposal_target_layer`, `rcnn_loss`) are not ported yet.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import nms as nms_ops
from ..utils import torch_common
from .layers import BatchNorm

BIG_NEG = -100000.0


def proposal_layer(batch_cls_preds, batch_box_preds, nms_pre, nms_post,
                   nms_thresh, rotated=True):
    """(B, A, C) logits, (B, A, 7) boxes -> {'rois': (B, nms_post, 7),
    'roi_raw_scores', 'roi_labels' int32, 'roi_valid' bool}: one batched
    NMS over all of each sample's boxes (`rotated=False`: the axis-aligned
    `nms_normal_gpu`)."""
    raw_top_scores = torch.amax(batch_cls_preds, dim=-1)           # (B, A)
    top_labels = torch.argmax(batch_cls_preds, dim=-1) + 1
    boxes5 = torch_common.boxes3d_to_bev_corner_format(batch_box_preds)
    selected, _ = nms_ops.nms_bev_batched(
        boxes5, raw_top_scores, nms_thresh, pre_max=nms_pre,
        post_max=nms_post, rotated=rotated)
    ok = selected >= 0
    sel = torch.where(ok, selected, 0).long()
    rois = (torch.gather(batch_box_preds, 1, sel[..., None].expand(
        -1, -1, batch_box_preds.shape[-1]))
        * ok[..., None].to(batch_box_preds.dtype))
    raw = torch.where(ok, torch.gather(raw_top_scores, 1, sel), BIG_NEG)
    labels = torch.where(ok, torch.gather(top_labels, 1, sel),
                         1).to(torch.int32)
    return {'rois': rois, 'roi_raw_scores': raw, 'roi_labels': labels,
            'roi_valid': ok}


def proposal_layer_from_head(cls_preds, box_raw, anchors, dir_raw, box_coder,
                             head_args, nms_pre, nms_post, nms_thresh,
                             rotated=True):
    """The proposal layer with selection before decode: the top `nms_pre`
    anchors by their best raw logit (ties to the lower index), decoded, then
    `proposal_layer` on them.

    :param cls_preds: (B, A, C) raw logits; :param box_raw: (B, A, code)
    :param anchors: (A, 7); :param dir_raw: (B, A, bins) or None
    """
    pre = min(int(nms_pre), anchors.shape[0])
    _, idx = nms_ops.topk_stable(torch.amax(cls_preds, dim=-1), pre)

    def take(x):
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    box_preds = box_coder.decode_with_head_direction(
        box_preds=take(box_raw), anchors=anchors[idx],
        dir_cls_preds=None if dir_raw is None else take(dir_raw),
        num_dir_bins=head_args.get('num_direction_bins', 2),
        dir_offset=head_args.get('dir_offset', 0.78539),
        dir_limit_offset=head_args.get('dir_limit_offset', 0.0),
        use_binary_dir_classifier=head_args.get('use_binary_dir_classifier',
                                                False))
    return proposal_layer(take(cls_preds), box_preds, nms_pre=pre,
                          nms_post=nms_post, nms_thresh=nms_thresh,
                          rotated=rotated)


class DenseConv3d(nn.Module):
    """Weight holder of a 3x3x3 conv over a RoI grid, spconv's (3, 3, 3,
    Cin, Cout) layout, no bias."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.fan_in = in_channels * 27                 # init_weights' bound
        self.weight = nn.Parameter(torch.zeros(3, 3, 3, in_channels,
                                               out_channels))

    def forward(self, x, compute_dtype=None):
        """(N, D, H, W, Cin) -> (N, D, H, W, Cout) f32, padding 1."""
        w = self.weight.permute(4, 3, 0, 1, 2)
        x = x.permute(0, 4, 1, 2, 3)
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        return F.conv3d(x, w, padding=1).float().permute(0, 2, 3, 4, 1)


class MaskedConv3dBNReLU(nn.Sequential):
    """A subm conv on a RoI grid as a dense conv: inactive inputs are zero
    upstream, BN over the active cells (in training), ReLU, `* occ`
    (conv at .0, BN at .1)."""

    def __init__(self, in_channels, out_channels):
        super().__init__(DenseConv3d(in_channels, out_channels),
                         BatchNorm(out_channels))

    def forward(self, x, occ, compute_dtype=None):
        conv, bn = self
        y = bn(conv(x, compute_dtype), occ)
        return torch.relu(y) * occ[..., None].to(y.dtype)


class Conv1x1(nn.Module):
    """pt_utils.Conv1d's conv: weight (out, in, 1), a bias only where no
    BN follows; applied as a linear map over (N, in)."""

    def __init__(self, in_channels, out_channels, bias):
        super().__init__()
        self.fan_in = in_channels                      # init_weights' bound
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x, compute_dtype=None):
        w = self.weight[..., 0]
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        y = F.linear(x, w).float()
        return y if self.bias is None else y + self.bias


class _BN(nn.Module):
    """pt_utils' BatchNorm1d wrapper: the BN sits at `.bn`."""

    def __init__(self, features):
        super().__init__()
        self.bn = BatchNorm(features)

    def forward(self, x):
        return self.bn(x)


class FCBlock(nn.Module):
    """pt_utils.Conv1d over (N, C): conv at `.conv`, BN at `.bn.bn`, ReLU
    (`pcdet_tpu.models.roi_heads.FCBlock`); `bn=False` is an output layer
    (a bias, no BN, no ReLU)."""

    def __init__(self, in_channels, out_channels, bn=True):
        super().__init__()
        self.conv = Conv1x1(in_channels, out_channels, bias=not bn)
        self.bn = _BN(out_channels) if bn else None

    def forward(self, x, compute_dtype=None):
        y = self.conv(x, compute_dtype)
        if self.bn is None:
            return y
        return torch.relu(self.bn(y))


def _fc_stack(in_channels, channels, dropout_after, dp_ratio):
    """FCBlocks with a Dropout after block i where `dropout_after(i)`."""
    layers = []
    for i, ch in enumerate(channels):
        layers.append(FCBlock(in_channels, ch))
        in_channels = ch
        if dropout_after(i):
            layers.append(nn.Dropout(dp_ratio))
    return layers


class _RCNNBase(nn.Module):
    """The towers both RCNN heads share: conv_part / conv_rpn, the shared FC
    stack over the flattened grid, and the cls / reg towers."""

    def __init__(self, num_point_features, part_channels, flat_channels,
                 shared_fc, cls_fc, reg_fc, dp_ratio, code_size,
                 compute_dtype_test):
        super().__init__()
        self.compute_dtype_test = (torch.bfloat16 if compute_dtype_test
                                   == 'bfloat16' else None)
        self.conv_part = nn.Sequential(MaskedConv3dBNReLU(4, 64),
                                       MaskedConv3dBNReLU(64, part_channels))
        self.conv_rpn = nn.Sequential(
            MaskedConv3dBNReLU(num_point_features, 64),
            MaskedConv3dBNReLU(64, part_channels))
        n_sh = len(shared_fc) - 1
        self.shared_fc_layer = nn.Sequential(*_fc_stack(
            flat_channels, shared_fc[1:],
            lambda i: i != n_sh - 1 and dp_ratio > 0, dp_ratio))
        for name, fcs, out in (('cls_layer', cls_fc, 1),
                               ('reg_layer', reg_fc, code_size)):
            layers = _fc_stack(shared_fc[-1], fcs,
                               lambda i: i == 0 and dp_ratio >= 0, dp_ratio)
            layers.append(FCBlock(fcs[-1], out, bn=False))
            setattr(self, name, nn.Sequential(*layers))

    @property
    def compute_dtype(self):
        return None if self.training else self.compute_dtype_test

    def parts(self, pooled_part, pooled_rpn):
        """occ, then [conv_rpn, conv_part] channels on the grid."""
        occ = torch.abs(pooled_part).sum(-1) > 0
        cd = self.compute_dtype
        x_part, x_rpn = pooled_part, pooled_rpn
        for conv in self.conv_part:
            x_part = conv(x_part, occ, cd)
        for conv in self.conv_rpn:
            x_rpn = conv(x_rpn, occ, cd)
        return occ, torch.cat([x_rpn, x_part], dim=-1)

    def heads(self, x):
        """(N, g, g, g, C) grid -> rcnn_cls (N, 1), rcnn_reg (N, code); the
        grid flattened channel-major as the reference's dense() + view."""
        cd = self.compute_dtype
        h = x.permute(0, 4, 1, 2, 3).reshape(x.shape[0], -1)
        for layer in self.shared_fc_layer:
            h = layer(h, cd) if isinstance(layer, FCBlock) else layer(h)
        outs = []
        for tower in (self.cls_layer, self.reg_layer):
            y = h
            for i, layer in enumerate(tower):
                if isinstance(layer, FCBlock):
                    # the output layer runs in f32, as in pcdet_tpu
                    y = layer(y, cd if i < len(tower) - 1 else None)
                else:
                    y = layer(y)
            outs.append(y)
        return outs[0], outs[1]


class SpConvRCNN(_RCNNBase):
    """SpConvRCNN (`pcdet_tpu.models.roi_heads.SpConvRCNNModule`):
    conv_part / conv_rpn on the 14³ grid, conv_down (two convs, a sparse
    2x2x2 max-pool, two convs), then the FC towers."""

    def __init__(self, num_point_features=16, shared_fc=(256, 512, 512, 512),
                 cls_fc=(256, 256), reg_fc=(256, 256), dp_ratio=0.3,
                 code_size=7, pool_size=14, compute_dtype_test=''):
        g = pool_size // 2
        super().__init__(num_point_features, 64, shared_fc[0] * g ** 3,
                         shared_fc, cls_fc, reg_fc, dp_ratio, code_size,
                         compute_dtype_test)
        self.conv_down = nn.Sequential(
            MaskedConv3dBNReLU(128, 128), MaskedConv3dBNReLU(128, 128),
            nn.MaxPool3d(2, 2), MaskedConv3dBNReLU(128, 128),
            MaskedConv3dBNReLU(128, shared_fc[0]))

    def forward(self, pooled_part, pooled_rpn):
        """:param pooled_part: (N, o, o, o, 4); :param pooled_rpn: (N, o, o,
        o, C) :return: rcnn_cls (N, 1), rcnn_reg (N, code)"""
        occ, x = self.parts(pooled_part, pooled_rpn)
        cd = self.compute_dtype
        c0, c1, pool, c3, c4 = self.conv_down
        x = c1(c0(x, occ, cd), occ, cd)
        # sparse max-pool: -inf on inactive cells; occupancy pooled alike
        neg = torch.where(occ[..., None], x, -math.inf).permute(0, 4, 1, 2, 3)
        pooled = pool(neg).permute(0, 2, 3, 4, 1)
        occ2 = pool(occ[:, None].float())[:, 0] > 0
        x = torch.where(torch.isfinite(pooled), pooled, 0.0)
        x = c4(c3(x, occ2, cd), occ2, cd)
        return self.heads(x)


class FCRCNN(_RCNNBase):
    """FCRCNN (`pcdet_tpu.models.roi_heads.FCRCNNModule`): conv_part /
    conv_rpn on the 12³ grid to shared_fc[0] / 2 channels each, then the FC
    towers."""

    def __init__(self, num_point_features=16, shared_fc=(128, 256, 256, 256),
                 cls_fc=(256, 256), reg_fc=(256, 256), dp_ratio=0.3,
                 code_size=7, pool_size=12, compute_dtype_test=''):
        super().__init__(num_point_features, shared_fc[0] // 2,
                         shared_fc[0] * pool_size ** 3, shared_fc, cls_fc,
                         reg_fc, dp_ratio, code_size, compute_dtype_test)

    def forward(self, pooled_part, pooled_rpn):
        return self.heads(self.parts(pooled_part, pooled_rpn)[1])


def decode_rcnn_boxes(rcnn_reg, rois, box_coder, code_size=7):
    """Refinements in each RoI's frame -> global boxes (B, N, code)
    (`pcdet_tpu.models.roi_heads.decode_rcnn_boxes`)."""
    b, n = rois.shape[0], rois.shape[1]
    rois_flat = rois.reshape(-1, code_size)
    local_rois = torch.cat([torch.zeros_like(rois_flat[:, :3]),
                            rois_flat[:, 3:]], dim=1)
    boxes = box_coder.decode(rcnn_reg.reshape(-1, code_size), local_rois)
    ang = rois_flat[:, 6] + math.pi / 2
    cosa, sina = torch.cos(ang), torch.sin(ang)
    x = boxes[:, 0] * cosa + boxes[:, 1] * sina
    y = -boxes[:, 0] * sina + boxes[:, 1] * cosa
    out = torch.cat([x[:, None] + rois_flat[:, 0:1],
                     y[:, None] + rois_flat[:, 1:2],
                     boxes[:, 2:3] + rois_flat[:, 2:3], boxes[:, 3:]], dim=1)
    return out.reshape(b, n, code_size)
