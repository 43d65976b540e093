"""SECOND's sparse 3D backbone on tensors, eval and training.

Twin of `pcdet_tpu.models.backbones3d.SpConvBNReLU` / `BackBone8x` with the
reference's module names (`conv_input.0`, `conv1.0.0`, `conv{2,3,4}.{0,1,2}.0`,
`conv_out.0`; BN at `.1`), so a reference state_dict loads as it is.
Sparse-conv weights keep spconv's layout (k0, k1, k2, Cin, Cout).

Every conv runs over a host-built rulebook (`ops/host_books.py`, keys of
`encoder_spec`): the 8 subm convs share the 4 subm books of their levels,
and each strided conv's book carries its output set.  In training the
backward of each conv runs over the mirrored (subm) or transposed
(strided) book; a level's mirrored book is built once and shared by its
subm convs.  BN then takes masked batch statistics.  `loads`
(`ops/sparse.Loads`) picks the kernels of the 11 convs whose kernel is 3
wide in x (all but conv_out): their books' x-window selectors are built
once per book and step here, with the transposed or mirrored book's when
a backward will run, and each selector build's count of dropped taps is
kept in `xwin_clamped` (0 on host books).
"""
import math

import torch
import torch.nn as nn

from ..ops import sparse
from .layers import BatchNorm


def effective_dtype(args, train=False):
    """Compute dtype of the conv stack: `compute_dtype` in training; in eval
    `compute_dtype_test`, else `compute_dtype`
    (`pcdet_tpu.models.backbones3d._effective_dtype`)."""
    name = str(args.get('compute_dtype', '') if train else
               args.get('compute_dtype_test', '') or
               args.get('compute_dtype', ''))
    return torch.bfloat16 if name == 'bfloat16' else None


def resolve_caps(cap, level_caps, level_caps_frac, n=4):
    """Static voxel caps of (conv2, conv3, conv4, conv_out): an absolute cap
    wins, else a fraction of the input cap rounded up to a multiple of 256,
    else the input cap; each at most 4x the input cap
    (`pcdet_tpu.models.backbones3d._resolve_caps`)."""
    bound = 4 * cap
    caps = []
    for i in range(n):
        a = level_caps[i] if i < len(level_caps) else 0
        f = level_caps_frac[i] if i < len(level_caps_frac) else 0.0
        if a:
            caps.append(min(int(a), bound))
        elif f:
            caps.append(min(int(-(-f * cap // 256) * 256), bound))
        else:
            caps.append(cap)
    return caps


class SparseConv3d(nn.Module):
    """Weight holder of a subm or strided sparse conv, (k0, k1, k2, Cin, Cout);
    no bias (BN follows)."""

    def __init__(self, in_channels, out_channels, kernel=(3, 3, 3),
                 stride=(1, 1, 1), padding=(1, 1, 1), subm=True):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.subm = subm
        self.fan_in = in_channels * math.prod(kernel)    # init_weights' bound
        self.weight = nn.Parameter(torch.zeros(*kernel, in_channels,
                                               out_channels))

    def forward(self, level, book, compute_dtype, loads, **shared):
        """`loads`: `sparse.Loads`, applied when the kernel is 3 wide in x;
        `shared`: what the convs of a level share, the keyword arguments
        of `sparse.subm_conv3d` / `sparse_conv3d` (mirror / bwd books and
        selectors)."""
        k = math.prod(self.kernel)
        w = self.weight.reshape(k, *self.weight.shape[3:])
        if self.subm:
            return sparse.subm_conv3d(level, w, book, compute_dtype,
                                      loads=loads, kw3=self.kernel[2] == 3,
                                      **shared)
        return sparse.sparse_conv3d(level, w, book, self.kernel, self.stride,
                                    self.padding, compute_dtype, loads=loads,
                                    **shared)


class SpConvBNReLU(nn.Sequential):
    """Sparse conv -> BN (masked batch statistics in training) -> ReLU ->
    `* mask` (spconv's post_act_block: conv at .0, BN at .1)."""

    def __init__(self, in_channels, out_channels, **conv_args):
        super().__init__(SparseConv3d(in_channels, out_channels, **conv_args),
                         BatchNorm(out_channels), nn.ReLU())

    def forward(self, level, book, compute_dtype, loads, **shared):
        conv, bn, relu = self
        out = conv(level, book, compute_dtype, loads, **shared)
        feats = relu(bn(out.features, out.mask))
        return out._replace(features=feats * out.mask[..., None].to(
            feats.dtype))


class BackBone8x(nn.Module):
    """SECOND sparse encoder -> dense BEV (B, H, W, 128 * D).

    :param last_pad: conv_out's padding ((0, 0, 0) for 0.1 / 0.2 m voxels)
    :param loads: `sparse.Loads` of the kw=3 convs (None:
        `sparse.DEFAULT_LOADS`; the layers above pass theirs through and
        those below take it as given)
    """

    def __init__(self, num_input_features=4, last_pad=(0, 0, 0),
                 loads=None):
        super().__init__()
        self.loads = sparse.Loads(
            *(sparse.DEFAULT_LOADS if loads is None else loads)).check()
        self.xwin_clamped = {}
        strided = dict(kernel=(3, 3, 3), stride=(2, 2, 2), padding=(1, 1, 1),
                       subm=False)
        self.conv_input = SpConvBNReLU(num_input_features, 16)
        self.conv1 = nn.Sequential(SpConvBNReLU(16, 16))
        self.conv2 = nn.Sequential(SpConvBNReLU(16, 32, **strided),
                                   SpConvBNReLU(32, 32), SpConvBNReLU(32, 32))
        self.conv3 = nn.Sequential(SpConvBNReLU(32, 64, **strided),
                                   SpConvBNReLU(64, 64), SpConvBNReLU(64, 64))
        self.conv4 = nn.Sequential(
            SpConvBNReLU(64, 64, **{**strided, 'padding': (0, 1, 1)}),
            SpConvBNReLU(64, 64), SpConvBNReLU(64, 64))
        self.conv_out = SpConvBNReLU(64, 128, kernel=(3, 1, 1),
                                     stride=(2, 1, 1),
                                     padding=tuple(last_pad), subm=False)

    @staticmethod
    def out_depth(sparse_shape, last_pad):
        """D of the BEV's 128 * D channels."""
        shape = tuple(sparse_shape)
        for pad in ((1, 1, 1), (1, 1, 1), (0, 1, 1)):
            shape = sparse.conv_out_shape(shape, 3, 2, pad)
        return sparse.conv_out_shape(shape, (3, 1, 1), (2, 1, 1),
                                     last_pad)[0]

    def shared_books(self, books, input_cap):
        """Per book key, what its convs share this step: for a subm level
        its mirrored book (a backward under `loads.fwd` rows), and for the
        kw=3 books their selectors where a window kernel will read them
        (`loads.fwd`, or `loads.dw` when a backward will run) and those of
        the mirrored or transposed book (a backward under window
        `loads.fwd`).  Records the selector builds' dropped taps."""
        backward = self.training and torch.is_grad_enabled()
        window = self.loads.fwd != 'rows' or (backward
                                              and self.loads.dw != 'rows')
        self.xwin_clamped = {}
        shared, n_in = {}, input_cap
        for key in ('subm1', 'spconv2', 'subm2', 'spconv3', 'subm3',
                    'spconv4', 'subm4'):
            subm = key.startswith('subm')
            rules = books[key] if subm else books[key][4]
            extra = {}
            if subm and backward and self.loads.fwd == 'rows':
                extra['mirror'] = rules.flip(-1)
            if window:
                base, sel, self.xwin_clamped[key] = sparse.xwin_selectors(
                    rules, n_in)
                extra['xwin'] = (base, sel)
                if backward and self.loads.fwd != 'rows':
                    if subm:
                        extra['mirror_xwin'] = sparse.mirror_xwin(base, sel)
                    else:
                        n_out = rules.shape[1]
                        bwd = sparse.transpose_rules(rules, n_in, n_out)
                        *bwd_xwin, self.xwin_clamped[key + '_t'] = \
                            sparse.xwin_selectors(bwd, n_out)
                        extra['bwd_xwin'] = tuple(bwd_xwin)
            if not subm:
                n_in = rules.shape[1]
            shared[key] = extra
        return shared

    def forward(self, level, books, compute_dtype=None):
        """:param level: full-resolution SparseLevel; :param books: decoded
        books of every `encoder_spec` key
        :return: BEV (B, H, W, 128 * D) f32, {conv2, conv3, conv4,
            conv_out: (B,) int32 drops of each strided conv's cap}"""
        cd = compute_dtype
        shared = self.shared_books(books, level.features.shape[1])
        x = self.conv_input(level, books['subm1'], cd, self.loads,
                            **shared['subm1'])
        x = self.conv1[0](x, books['subm1'], cd, self.loads, **shared['subm1'])
        overflow = {}
        for name, stage, sk, bk in (('conv2', self.conv2, 'subm2', 'spconv2'),
                                    ('conv3', self.conv3, 'subm3', 'spconv3'),
                                    ('conv4', self.conv4, 'subm4', 'spconv4')):
            x = stage[0](x, books[bk], cd, self.loads, **shared[bk])
            overflow[name] = x.overflow
            x = stage[1](x, books[sk], cd, self.loads, **shared[sk])
            x = stage[2](x, books[sk], cd, self.loads, **shared[sk])
        out = self.conv_out(x, books['convout'], cd, self.loads)
        overflow['conv_out'] = out.overflow

        dense = sparse.to_dense(out)                   # (B, D, H, W, 128)
        b, d, h, w, c = dense.shape
        # z folds into channels as channel c * D + d, the reference's
        # .dense() + view(N, C * D, H, W)
        bev = dense.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d)
        return bev, overflow
