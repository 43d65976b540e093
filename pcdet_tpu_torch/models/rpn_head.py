"""RPNV2 dense BEV head (forward) on tensors.

Twin of `pcdet_tpu.models.rpn_head.RPNV2` with the reference's module
names: block i is Sequential(ZeroPad2d(1), Conv, BN, ReLU, [Conv, BN,
ReLU] * layer_num), so conv j sits at `blocks.{i}.{1+3j}` and its BN at
`.{2+3j}`; deblock i is `deblocks.{i}` = (ConvTranspose2d, BN, ReLU).

The convolutions run NCHW on a channels-last view of the NHWC canvas; the
head outputs come back NHWC, (B, H, W, A * code), so the anchor order of
`pcdet_tpu.models.anchors` holds.
"""
import math

import torch
import torch.nn as nn

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

        c_head = sum(num_upsample_filters) + (
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
        """:param canvas: (B, H, W, C) NHWC -> dict of NHWC head outputs."""
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
               'cls_preds': nhwc(self.conv_cls(x))}
        if self.conv_dir_cls is not None:
            ret['dir_cls_preds'] = nhwc(self.conv_dir_cls(x))
        return ret
