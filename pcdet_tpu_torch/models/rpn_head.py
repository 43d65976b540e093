"""RPNV2 dense BEV head and the anchor-head losses on tensors.

Twin of `pcdet_tpu.models.rpn_head.RPNV2` with the reference's module
names: block i is Sequential(ZeroPad2d(1), Conv, BN, ReLU, [Conv, BN,
ReLU] * layer_num), so conv j sits at `blocks.{i}.{1+3j}` and its BN at
`.{2+3j}`; deblock i is `deblocks.{i}` = (ConvTranspose2d, BN, ReLU).

The convolutions run NCHW on a channels-last view of the NHWC canvas; the
head outputs come back NHWC, (B, H, W, A * code), so the anchor order of
`pcdet_tpu.models.anchors` holds, with the concatenated upsampled features
the 1x1 heads read as `spatial_features_last` (B, H, W, C), which the
fork's BEV segmentation head reads.  The bf16 compute dtype applies in eval
only; training runs f32 (`layers.TorchConv`).
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import loss as loss_ops
from ..utils.profiler import span
from .layers import ConvBNReLU, DeconvBNReLU, TorchConv


class RPNV2(nn.Module):
    def __init__(self, num_class, num_anchors_per_location, num_input_features,
                 box_code_size=7, layer_nums=(3, 5, 5), layer_strides=(2, 2, 2),
                 num_filters=(64, 128, 256), upsample_strides=(1, 2, 4),
                 num_upsample_filters=(128, 128, 128), use_norm=True,
                 concat_input=False, encode_background_as_zeros=True,
                 use_direction_classifier=True, num_direction_bins=2,
                 compute_dtype=None):
        super().__init__()
        self.concat_input = concat_input
        cd = compute_dtype
        blocks, deblocks = [], []
        c_in = num_input_features
        for i, layer_num in enumerate(layer_nums):
            nf = num_filters[i]
            layers = [nn.ZeroPad2d(1),
                      *ConvBNReLU(c_in, nf, 3, layer_strides[i], padding=0,
                                  use_norm=use_norm, compute_dtype=cd)]
            for _ in range(layer_num):
                layers += [*ConvBNReLU(nf, nf, 3, 1, padding=1,
                                       use_norm=use_norm, compute_dtype=cd)]
            blocks.append(nn.Sequential(*layers))
            deblocks.append(DeconvBNReLU(nf, num_upsample_filters[i],
                                         upsample_strides[i],
                                         use_norm=use_norm, compute_dtype=cd))
            c_in = nf
        self.blocks = nn.ModuleList(blocks)
        self.deblocks = nn.ModuleList(deblocks)

        # the width of spatial_features_last
        self.c_head = c_head = sum(num_upsample_filters) + (
            num_input_features if concat_input else 0)
        a = num_anchors_per_location
        num_cls = a * num_class if encode_background_as_zeros \
            else a * (num_class + 1)
        self.conv_box = TorchConv(c_head, a * box_code_size, 1)
        self.conv_cls = TorchConv(c_head, num_cls, 1)
        self.conv_dir_cls = (TorchConv(c_head, a * num_direction_bins, 1)
                             if use_direction_classifier else None)

    @torch.no_grad()
    def init_focal_bias(self, prior=0.01):
        """conv_cls bias at the focal-loss prior, as the JAX head inits it."""
        self.conv_cls.bias.fill_(-math.log((1 - prior) / prior))

    def forward(self, canvas):
        """:param canvas: (B, H, W, C) NHWC -> dict of NHWC head outputs,
        in the span `pcdet.rpn`."""
        with span('pcdet.rpn'):
            return self._forward(canvas)

    def _forward(self, canvas):
        x_in = canvas.permute(0, 3, 1, 2)              # channels-last NCHW
        x = x_in
        ups = []
        for block, deblock in zip(self.blocks, self.deblocks):
            x = block(x)
            ups.append(deblock(x))
        if self.concat_input:
            ups.append(x_in)
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        ret = {'box_preds': nhwc(self.conv_box(x)),
               'cls_preds': nhwc(self.conv_cls(x)),
               'spatial_features_last': nhwc(x)}
        if self.conv_dir_cls is not None:
            ret['dir_cls_preds'] = nhwc(self.conv_dir_cls(x))
        return ret


def anchor_head_loss(ret_dict, anchors, box_cls_labels, box_reg_targets,
                     num_class, loss_weights, box_code_size=7,
                     encode_background_as_zeros=True,
                     use_direction_classifier=True, dir_offset=0.78539,
                     num_direction_bins=2, world=1):
    """RPN losses: focal cls + smooth-L1 (sin) loc + direction CE
    (`pcdet_tpu.models.rpn_head.anchor_head_loss`; reference
    rpn_head.AnchorHead.get_loss:129-210).  Each term is divided by the
    global batch, this batch times `world` (the ranks, each with a batch
    of this size), so a rank's loss is its share of the global batch's.

    :param ret_dict: NHWC head outputs; :param anchors: (A, 7)
    :param box_cls_labels: (B, A) int32, -1 don't care / 0 bg / 1..C fg
    :param box_reg_targets: (B, A, code)
    :return: rpn_loss, tb {rpn_loss_loc, rpn_loss_cls, rpn_loss_dir,
        rpn_loss}
    """
    box_preds = ret_dict['box_preds']
    cls_preds = ret_dict['cls_preds']
    dir_preds = ret_dict.get('dir_cls_preds', None)
    batch_size = box_preds.shape[0]
    global_batch = batch_size * world
    f32 = box_preds.dtype

    cared = box_cls_labels >= 0
    positives = box_cls_labels > 0
    negatives = box_cls_labels == 0
    cls_weights = negatives.to(f32) + positives.to(f32)
    reg_weights = positives.to(f32)
    pos_norm = torch.clamp(positives.sum(dim=1, keepdim=True).to(f32),
                           min=1.0)
    reg_weights = reg_weights / pos_norm
    cls_weights = cls_weights / pos_norm

    cls_targets = box_cls_labels * cared.to(box_cls_labels.dtype)
    one_hot = F.one_hot(cls_targets.long(), num_class + 1).to(f32)
    if encode_background_as_zeros:
        cls_preds = cls_preds.reshape(batch_size, -1, num_class)
        one_hot = one_hot[..., 1:]
    else:
        cls_preds = cls_preds.reshape(batch_size, -1, num_class + 1)

    cls_loss = loss_ops.sigmoid_focal_loss(cls_preds, one_hot, cls_weights,
                                           gamma=2.0, alpha=0.25)
    cls_loss_reduced = (cls_loss.sum() / global_batch
                        * loss_weights['rpn_cls_weight'])

    box_preds = box_preds.reshape(batch_size, -1, box_code_size)
    box_preds_sin, reg_targets_sin = loss_ops.add_sin_difference(
        box_preds, box_reg_targets)
    loc_loss = loss_ops.weighted_smooth_l1(
        box_preds_sin, reg_targets_sin, weights=reg_weights, sigma=3.0,
        code_weights=loss_weights['code_weights'])
    loc_loss_reduced = (loc_loss.sum() / global_batch
                        * loss_weights['rpn_loc_weight'])

    rpn_loss = loc_loss_reduced + cls_loss_reduced
    tb = {'rpn_loss_loc': loc_loss_reduced, 'rpn_loss_cls': cls_loss_reduced}

    if use_direction_classifier and dir_preds is not None:
        batch_anchors = anchors[None].expand(batch_size, *anchors.shape)
        dir_targets = loss_ops.get_direction_target(
            batch_anchors, box_reg_targets, dir_offset=dir_offset,
            num_bins=num_direction_bins)
        dir_logits = dir_preds.reshape(batch_size, -1, num_direction_bins)
        weights = positives.to(dir_logits.dtype)
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1.0)
        dir_loss = loss_ops.weighted_softmax_ce(dir_logits, dir_targets,
                                                weights)
        dir_loss = (dir_loss.sum() / global_batch
                    * loss_weights['rpn_dir_weight'])
        rpn_loss = rpn_loss + dir_loss
        tb['rpn_loss_dir'] = dir_loss

    tb['rpn_loss'] = rpn_loss
    return rpn_loss, tb
