"""Part-A²'s second stage: the proposal layer, the RoI sampler and its
targets, the RCNN heads over the pooled RoI grids, their loss, and the
refined boxes' decode.

Twin of `pcdet_tpu.models.roi_heads` (`proposal_layer`,
`proposal_layer_from_head`, `sample_rois_for_rcnn_single` batched as
`sample_rois`, `proposal_target_layer`, `MaskedConv3dBNReLU`, `FCBlock`,
`SpConvRCNNModule`, `FCRCNNModule`, `rcnn_loss`, `decode_rcnn_boxes`).
The proposal NMS runs through `ops/nms.py`, whose rotated IoU rows are
kernel A, as is the sampler's RoI-GT 3-D IoU (one launch a batch).  The
RCNN's sparse convs over the 14³ (12³) RoI grids are dense 3-D convs with
the inactive cells zero and the outputs masked to the active ones, as in
`pcdet_tpu`; they stay `torch.nn.functional.conv3d`.  Module names follow
the reference's partA2_rcnn_net.py (`rcnn_net.conv_part.0.0.weight`,
`rcnn_net.shared_fc_layer.{i}.conv.weight`, `...bn.bn.*`; dropouts keep
their Sequential indices), as `pcdet_tpu.train.torch_import.map_rcnn`
reads them; the dense conv weights keep spconv's (k, k, k, Cin, Cout)
layout.  The first shared FC reads the grid flattened channel-major, the
reference's order.  In training the 3-D convs' BNs take batch statistics
over the occupied cells and the FCs' over the RoIs; `Dropout` draws its
masks from an explicit generator (off in eval).  The sampler's random
picks come from a generator on the device too; both can be given instead
(`picks`, `Dropout.fixed_mask`), which is how two devices, or this port
and `pcdet_tpu`, are held to one draw.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import nms as nms_ops
from ..ops import rotated_iou
from ..parallel import ddp
from ..utils import loss as loss_ops
from ..utils import torch_common
from ..utils.box_coder import ResidualCoder
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


def _nth_true(mask, k):
    """Index of the k-th (0-based) True entry of each row of `mask` (B, M)
    for k (B, R) int64; 0 where the row has no True entry."""
    csum = torch.cumsum(mask.to(torch.int64), dim=1)
    idx = torch.searchsorted(csum, k + 1)
    return torch.where(csum[:, -1:] > 0, idx.clamp(max=mask.shape[1] - 1), 0)


def masked_choice(mask, num, replace, generator):
    """`num` indices per row drawn uniformly from the True entries of `mask`
    (B, M) (`pcdet_tpu.models.roi_heads._masked_choice`): with replacement
    (one uniform draw a slot), or without (a random order of the True
    entries first, then the others); 0 where a row has none.

    :return: (B, num) int64
    """
    b, m = mask.shape
    dev = mask.device
    if replace:
        n = mask.sum(dim=1, keepdim=True)
        u = torch.rand((b, num), generator=generator, device=dev)
        k = torch.minimum((u * n).to(torch.int64), (n - 1).clamp(min=0))
        return _nth_true(mask, k)
    u = torch.rand((b, m), generator=generator, device=dev)
    order = torch.argsort(torch.where(mask, u, u + 2.0), dim=1)
    if num > m:
        order = torch.cat([order, order.new_zeros((b, num - m))], dim=1)
    return order[:, :num]


def rois_iou3d(rois, gt_boxes):
    """The sampler's 3-D IoU, (B, M, 7) x (B, G, 7) -> (B, M, G) f32: kernel
    A in one launch (its plain version on the CPU), in f32 whatever the
    boxes' dtype, as kernel A takes them."""
    return rotated_iou.boxes_iou3d_batched(rois.float(), gt_boxes.float())


def sample_rois(rois, roi_raw_scores, roi_labels, roi_valid, gt_boxes,
                sampler_cfg, num_class, generator=None, picks=None):
    """The RoI sampler of a batch (`pcdet_tpu.models.roi_heads.
    sample_rois_for_rcnn_single` per sample; the reference's
    sample_rois_for_rcnn:45-162), no host round trip: the class-aware 3-D
    IoU of every proposal with every GT (kernel A, one launch), the fg /
    easy-bg / hard-bg masks, then ROI_PER_IMAGE slots, the first `fg_count`
    fg picks (without replacement where bg exists, else with) and the rest
    bg: `hard_num` hard picks, then easy ones (with replacement).

    :param rois: (B, M, 7); :param gt_boxes: (B, G, 8), zero-padded, the
        class id last
    :param generator: the draws' torch.Generator on the rois' device
    :param picks: (B, R) proposal indices to take instead of drawing them
        (what another device or `pcdet_tpu` drew)
    :return: dict of (B, R) tensors: rois, gt_of_rois, roi_iou,
        roi_raw_scores, roi_labels, valid; picks int64; and the counts per
        sample n_fg, n_hard, n_easy, fg_count, hard_num (int64)
    """
    sc = sampler_cfg
    r = int(sc.ROI_PER_IMAGE)
    fg_per_image = int(round(sc.FG_RATIO * r))
    reg_fg = float(sc.REG_FG_THRESH)
    cls_bg_lo = float(sc.CLS_BG_THRESH_LO)
    b = rois.shape[0]

    gt_valid = torch.abs(gt_boxes[..., :7]).sum(dim=-1) > 0        # (B, G)
    iou = rois_iou3d(rois, gt_boxes[..., :7])
    if num_class > 1:
        same = roi_labels[:, :, None] == gt_boxes[:, None, :, 7].to(
            torch.int32)
        iou = torch.where(same, iou, 0.0)
    iou = torch.where(gt_valid[:, None, :] & roi_valid[:, :, None], iou, 0.0)
    max_overlaps, gt_assignment = torch.max(iou, dim=2)

    fg_mask = (max_overlaps >= min(reg_fg, float(sc.CLS_FG_THRESH))) \
        & roi_valid
    easy_mask = (max_overlaps < cls_bg_lo) & roi_valid
    hard_mask = ((max_overlaps < reg_fg) & (max_overlaps >= cls_bg_lo)
                 & roi_valid)
    n_fg, n_easy, n_hard = (m.sum(dim=1) for m in (fg_mask, easy_mask,
                                                    hard_mask))
    n_bg = n_easy + n_hard

    fg_count = torch.where(n_bg > 0, torch.clamp(n_fg, max=fg_per_image), r)
    fg_count = torch.where(n_fg > 0, fg_count, 0)
    bg_count = r - fg_count
    hard_num = torch.where(
        (n_hard > 0) & (n_easy > 0),
        (bg_count.to(torch.float32) * float(sc.HARD_BG_RATIO)).to(
            torch.int64),
        torch.where(n_hard > 0, bg_count, 0))
    slots = torch.arange(r, device=rois.device)[None]
    if picks is None:
        fg_pick = torch.where(
            (n_bg > 0)[:, None],
            masked_choice(fg_mask, r, False, generator),
            masked_choice(fg_mask, r, True, generator))
        bg_pick = torch.where(slots - fg_count[:, None] < hard_num[:, None],
                              masked_choice(hard_mask, r, True, generator),
                              masked_choice(easy_mask, r, True, generator))
        picks = torch.where(slots < fg_count[:, None], fg_pick, bg_pick)
    picks = picks.to(rois.device, torch.int64)
    if tuple(picks.shape) != (b, r):
        raise ValueError('picks %s: want (B, ROI_PER_IMAGE) = %s'
                         % (tuple(picks.shape), (b, r)))

    def take(x):
        if x.dim() == 2:
            return torch.gather(x, 1, picks)
        return torch.gather(x, 1, picks[..., None].expand(-1, -1,
                                                          x.shape[-1]))

    assigned = torch.gather(gt_assignment, 1, picks)
    return {'rois': take(rois),
            'gt_of_rois': torch.gather(gt_boxes, 1, assigned[..., None].expand(
                -1, -1, gt_boxes.shape[-1])),
            'roi_iou': take(max_overlaps),
            'roi_raw_scores': take(roi_raw_scores),
            'roi_labels': take(roi_labels),
            'valid': (n_fg + n_bg > 0)[:, None].expand(b, r),
            'picks': picks, 'n_fg': n_fg, 'n_hard': n_hard, 'n_easy': n_easy,
            'fg_count': fg_count, 'hard_num': hard_num}


def proposal_target_layer(roi_dict, gt_boxes, sampler_cfg, num_class,
                          generator=None, picks=None):
    """Sampling, the classification targets and the canonical transform of
    each sampled RoI's GT into its frame (`pcdet_tpu.models.roi_heads.
    proposal_target_layer`; the reference's proposal_target_layer:7-42 and
    RCNNHead.assign_targets:25-54).

    :return: rois, gt_of_rois (canonical), gt_of_rois_src, gt_iou,
        rcnn_cls_labels, reg_valid_mask int32, roi_raw_scores, roi_labels,
        roi_valid, and `sampler`: the sampler's picks and counts
    """
    sc = sampler_cfg
    sampled = sample_rois(roi_dict['rois'], roi_dict['roi_raw_scores'],
                          roi_dict['roi_labels'], roi_dict['roi_valid'],
                          gt_boxes, sc, num_class, generator, picks)
    roi_iou, valid = sampled['roi_iou'], sampled['valid']
    reg_valid_mask = ((roi_iou > float(sc.REG_FG_THRESH)).to(torch.int32)
                      * valid.to(torch.int32))
    fg_thresh, bg_thresh = float(sc.CLS_FG_THRESH), float(sc.CLS_BG_THRESH)
    if sc.CLS_SCORE_TYPE == 'cls':
        cls_label = (roi_iou > fg_thresh).to(torch.float32)
        cls_label = torch.where((roi_iou > bg_thresh) & (roi_iou < fg_thresh),
                                -1.0, cls_label)
    elif sc.CLS_SCORE_TYPE == 'roi_iou':
        fg, bg = roi_iou > fg_thresh, roi_iou < bg_thresh
        cls_label = torch.where(~fg & ~bg, roi_iou * 2 - 0.5,
                                fg.to(torch.float32))
    else:
        raise NotImplementedError(sc.CLS_SCORE_TYPE)
    cls_label = torch.where(valid, cls_label, -1.0)

    rois, src = sampled['rois'], sampled['gt_of_rois']
    roi_ry = torch.remainder(rois[..., 6], 2 * math.pi)
    xyz = src[..., 0:3] - rois[..., 0:3]
    ry = src[..., 6] - roi_ry
    ang = -(roi_ry + math.pi / 2)
    cosa, sina = torch.cos(ang), torch.sin(ang)
    xr = xyz[..., 0] * cosa + xyz[..., 1] * sina
    yr = -xyz[..., 0] * sina + xyz[..., 1] * cosa
    ry = torch.remainder(ry, 2 * math.pi)
    opposite = (ry > math.pi * 0.5) & (ry < math.pi * 1.5)
    ry = torch.where(opposite, torch.remainder(ry + math.pi, 2 * math.pi), ry)
    ry = torch.where(ry > math.pi, ry - math.pi * 2, ry)
    ry = torch.clamp(ry, -math.pi / 2, math.pi / 2)
    gt = torch.cat([xr[..., None], yr[..., None], xyz[..., 2:3],
                    src[..., 3:6], ry[..., None], src[..., 7:]], dim=-1)
    return {'rois': rois, 'gt_of_rois': gt, 'gt_of_rois_src': src,
            'gt_iou': roi_iou, 'rcnn_cls_labels': cls_label,
            'reg_valid_mask': reg_valid_mask,
            'roi_raw_scores': sampled['roi_raw_scores'],
            'roi_labels': sampled['roi_labels'], 'roi_valid': valid,
            'sampler': {k: sampled[k] for k in (
                'picks', 'n_fg', 'n_hard', 'n_easy', 'fg_count',
                'hard_num')}}


class DenseConv3d(nn.Module):
    """Weight holder of a 3x3x3 conv over a RoI grid, spconv's (3, 3, 3,
    Cin, Cout) layout, no bias."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.fan_in = in_channels * 27                 # init_weights' bound
        self.weight = nn.Parameter(torch.zeros(3, 3, 3, in_channels,
                                               out_channels))

    def forward(self, x, compute_dtype=None):
        """(N, D, H, W, Cin) -> (N, D, H, W, Cout), padding 1; in the
        input's dtype, or f32 under a `compute_dtype`."""
        w = self.weight.permute(4, 3, 0, 1, 2)
        x = x.permute(0, 4, 1, 2, 3)
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        y = F.conv3d(x, w, padding=1)
        if compute_dtype is not None:
            y = y.float()
        return y.permute(0, 2, 3, 4, 1)


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
        y = F.linear(x, w)
        if compute_dtype is not None:
            y = y.float()
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


class Dropout(nn.Module):
    """Dropout whose mask is drawn from `generator` (an explicit
    torch.Generator on the input's device, set by the trainer; None:
    torch's default one of that device), as flax's Dropout keeps with
    probability 1 - p and scales by 1 / (1 - p).  `fixed_mask`, where set,
    is used instead of a draw; `last_mask` keeps the mask of the last
    training forward.  Identity in eval and at p = 0."""

    def __init__(self, p):
        super().__init__()
        self.p = float(p)
        self.generator = None
        self.fixed_mask = None
        self.last_mask = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = self.fixed_mask
        if keep is None:
            keep = torch.rand(x.shape, generator=self.generator,
                              device=x.device) >= self.p
        keep = keep.to(x.device)
        self.last_mask = keep
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def _fc_stack(in_channels, channels, dropout_after, dp_ratio):
    """FCBlocks with a Dropout after block i where `dropout_after(i)`."""
    layers = []
    for i, ch in enumerate(channels):
        layers.append(FCBlock(in_channels, ch))
        in_channels = ch
        if dropout_after(i):
            layers.append(Dropout(dp_ratio))
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


def rcnn_loss(forward_ret, loss_weights, corner_loss_regularization=True,
              code_size=7, group=None):
    """The RCNN's BCE class loss over the valid labels, and its smooth-L1
    and corner losses over the fg RoIs (`pcdet_tpu.models.roi_heads.
    rcnn_loss`; the reference's RCNNHead.get_loss:56-143).  Rows that are
    not fg take a unit box before the encode and decode, so that a padded
    RoI of zero size cannot put a NaN (log 0, / 0) into the masked sums.
    With a process `group` the normalizers (the valid labels, the fg RoIs)
    are the global batch's, summed over the ranks, so the loss is this
    rank's share of the global batch's.

    :return: loss, tb {rcnn_loss_cls, rcnn_loss_reg, rcnn_loss_corner,
        rcnn_loss}
    """
    coder = ResidualCoder()
    rcnn_cls = forward_ret['rcnn_cls'].reshape(-1)
    cls_labels = forward_ret['rcnn_cls_labels'].reshape(-1)
    reg_valid = forward_ret['reg_valid_mask'].reshape(-1)
    gt_ct = forward_ret['gt_of_rois'][..., :code_size].reshape(-1, code_size)
    gt_src = forward_ret['gt_of_rois_src'][..., :code_size].reshape(
        -1, code_size)
    rcnn_reg = forward_ret['rcnn_reg'].reshape(-1, code_size)
    rois = forward_ret['rois'].reshape(-1, code_size)

    p = torch.sigmoid(rcnn_cls)
    eps = 1e-7
    bce = -(cls_labels * torch.log(torch.clamp(p, eps, 1.0))
            + (1 - cls_labels) * torch.log(torch.clamp(1 - p, eps, 1.0)))
    cls_valid = (cls_labels >= 0).to(torch.float32)
    fg = (reg_valid > 0).to(torch.float32)
    if group is None:
        valid_sum, fg_total = cls_valid.sum(), fg.sum()
    else:
        valid_sum, fg_total = ddp.all_sum(
            torch.stack([cls_valid.sum(), fg.sum()]), group)
    loss_cls = ((bce * cls_valid).sum() / torch.clamp(valid_sum, min=1.0)
                * loss_weights['rcnn_cls_weight'])

    fg_sum = torch.clamp(fg_total, min=1.0)
    safe = fg[:, None] > 0
    dummy = rois.new_tensor([0, 0, 0, 1, 1, 1, 0])
    rois_safe = torch.where(safe, rois, dummy)
    gt_ct_safe = torch.where(safe, gt_ct, dummy)
    gt_src_safe = torch.where(safe, gt_src, dummy)
    zero3 = torch.zeros_like(rois_safe[:, :3])
    rois_anchor = torch.cat([zero3, rois_safe[:, 3:6],
                             torch.zeros_like(rois_safe[:, 6:7]),
                             rois_safe[:, 7:]], dim=1)
    reg_targets = coder.encode(gt_ct_safe, rois_anchor)
    reg_l = loss_ops.weighted_smooth_l1(
        rcnn_reg[None], reg_targets[None], sigma=3.0,
        code_weights=loss_weights['code_weights'])[0]
    loss_reg = ((reg_l * fg[:, None]).sum() / fg_sum
                * loss_weights['rcnn_reg_weight'])
    tb = {'rcnn_loss_cls': loss_cls, 'rcnn_loss_reg': loss_reg}

    if corner_loss_regularization:
        local = coder.decode(rcnn_reg, torch.cat([zero3, rois_safe[:, 3:]],
                                                 dim=1))
        ang = rois_safe[:, 6] + math.pi / 2
        cosa, sina = torch.cos(ang), torch.sin(ang)
        x = local[:, 0] * cosa + local[:, 1] * sina
        y = -local[:, 0] * sina + local[:, 1] * cosa
        boxes = torch.cat([x[:, None] + rois[:, 0:1],
                           y[:, None] + rois[:, 1:2],
                           local[:, 2:3] + rois[:, 2:3], local[:, 3:]],
                          dim=1)
        corner = loss_ops.corner_loss_lidar(boxes[:, :7], gt_src_safe[:, :7])
        loss_corner = ((corner * fg).sum() / fg_sum
                       * loss_weights['rcnn_corner_weight'])
        loss_reg = loss_reg + loss_corner
        tb['rcnn_loss_corner'] = loss_corner
    total = loss_cls + loss_reg
    tb['rcnn_loss'] = total
    return total, tb


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
