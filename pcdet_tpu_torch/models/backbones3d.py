"""SECOND's sparse 3D backbone and Part-A²'s sparse UNet on tensors, eval
and training.

Twin of `pcdet_tpu.models.backbones3d.SpConvBNReLU` / `BackBone8x` /
`SparseBasicBlock` / `SparseBottleneck` / `UNetV2` with the reference's
module names
(`conv_input.0`, `conv1.0.0`, `conv{2,3,4}.{0,1,2}.0`, `conv_out.0`; BN at
`.1`; the UNet's `conv_up_t{n}.{conv1,bn1,conv2,bn2}`, `conv_up_m{n}`,
`inv_conv{n}`, `conv5.0`, `seg_{cls,reg}_layer`), so a reference
state_dict loads as it is.
Sparse-conv weights keep spconv's layout (k0, k1, k2, Cin, Cout).

Every conv runs over a rulebook built on the host (`ops/host_books.py`,
keys of `encoder_spec`) or, under PCDET_HOST_BOOKS=0, on the device
(`host_books.build_books_device`): the 8 subm convs share the 4 subm
books of their levels,
and each strided conv's book carries its output set.  In training the
backward of each conv runs over the mirrored (subm) or transposed
(strided) book; a level's mirrored book is built once and shared by its
subm convs.  BN then takes masked batch statistics.  `loads`
(`ops/sparse.Loads`) picks the kernels of the 11 convs whose kernel is 3
wide in x (all but conv_out): their books' x-window selectors are built
once per book and step here, with the transposed or mirrored book's when
a backward will run, and each selector build's count of dropped taps is
kept in `xwin_clamped` (0 on host and device books).
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
                 stride=(1, 1, 1), padding=(1, 1, 1), subm=True,
                 inverse=False):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.subm, self.inverse = subm, inverse
        self.fan_in = in_channels * math.prod(kernel)    # init_weights' bound
        self.weight = nn.Parameter(torch.zeros(*kernel, in_channels,
                                               out_channels))

    def forward(self, level, book, compute_dtype, loads, **shared):
        """`loads`: `sparse.Loads`, applied when the kernel is 3 wide in x;
        `shared`: what the convs of a level share, the keyword arguments
        of `sparse.subm_conv3d` / `sparse_conv3d` / `inverse_conv3d`
        (mirror / bwd books and selectors; an inverse conv's `target`
        level and the transposed book `rules_t`).  An inverse conv's
        `book` is the forward book of the strided conv it inverts, whose
        kernel, stride and padding it holds."""
        k = math.prod(self.kernel)
        w = self.weight.reshape(k, *self.weight.shape[3:])
        if self.subm:
            return sparse.subm_conv3d(level, w, book, compute_dtype,
                                      loads=loads, kw3=self.kernel[2] == 3,
                                      **shared)
        if self.inverse:
            target = shared.pop('target')
            return sparse.inverse_conv3d(level, target, w, book, self.kernel,
                                         self.stride, self.padding,
                                         compute_dtype, loads=loads, **shared)
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

    def encode(self, level, books, compute_dtype, shared):
        """The encoder over `shared_books`' sharing: its levels x1 .. x4
        (after conv1, conv2, conv3, conv4), conv_out's output and the
        drops of each strided conv's cap."""
        cd = compute_dtype
        x = self.conv_input(level, books['subm1'], cd, self.loads,
                            **shared['subm1'])
        x = self.conv1[0](x, books['subm1'], cd, self.loads, **shared['subm1'])
        levels, overflow = [x], {}
        for name, stage, sk, bk in (('conv2', self.conv2, 'subm2', 'spconv2'),
                                    ('conv3', self.conv3, 'subm3', 'spconv3'),
                                    ('conv4', self.conv4, 'subm4', 'spconv4')):
            x = stage[0](x, books[bk], cd, self.loads, **shared[bk])
            overflow[name] = x.overflow
            x = stage[1](x, books[sk], cd, self.loads, **shared[sk])
            x = stage[2](x, books[sk], cd, self.loads, **shared[sk])
            levels.append(x)
        out = self.conv_out(x, books['convout'], cd, self.loads)
        overflow['conv_out'] = out.overflow
        return levels, out, overflow

    @staticmethod
    def to_bev(out):
        """conv_out's level -> (B, H, W, 128 * D) f32."""
        dense = sparse.to_dense(out)                   # (B, D, H, W, 128)
        b, d, h, w, c = dense.shape
        # z folds into channels as channel c * D + d, the reference's
        # .dense() + view(N, C * D, H, W)
        return dense.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d)

    def forward(self, level, books, compute_dtype=None):
        """:param level: full-resolution SparseLevel; :param books: decoded
        books of every `encoder_spec` key
        :return: BEV (B, H, W, 128 * D) f32, {conv2, conv3, conv4,
            conv_out: (B,) int32 drops of each strided conv's cap}"""
        shared = self.shared_books(books, level.features.shape[1])
        _, out, overflow = self.encode(level, books, compute_dtype, shared)
        return self.to_bev(out), overflow


class SparseBasicBlock(nn.Module):
    """Residual block of two subm convs over one book (`pcdet_tpu.models.
    backbones3d.SparseBasicBlock`, the reference's resnet_utils.py): conv1
    -> bn1 -> ReLU -> conv2 -> bn2, plus the input, ReLU, `* mask`."""

    def __init__(self, planes):
        super().__init__()
        self.conv1 = SparseConv3d(planes, planes)
        self.bn1 = BatchNorm(planes)
        self.conv2 = SparseConv3d(planes, planes)
        self.bn2 = BatchNorm(planes)

    def forward(self, level, book, compute_dtype, loads, **shared):
        mask = level.mask[..., None].to(level.features.dtype)
        out = self.conv1(level, book, compute_dtype, loads, **shared)
        f = torch.relu(self.bn1(out.features, out.mask)) * mask
        out = self.conv2(out._replace(features=f), book, compute_dtype, loads,
                         **shared)
        f = torch.relu(self.bn2(out.features, out.mask) + level.features)
        return out._replace(features=f * mask)


class SparseBottleneck(nn.Module):
    """1x1x1 -> 3x3x3 -> 1x1x1 residual bottleneck of subm convs, expansion
    4 (`pcdet_tpu.models.backbones3d.SparseBottleneck`, the reference's
    resnet_utils.py:51-86; in the block library, used by no shipped
    model): conv1 -> bn1 -> ReLU -> conv2 -> bn2 -> ReLU -> conv3 -> bn3,
    plus the input, or where `inplanes` != 4 * planes its 1x1x1
    projection (`downsample`: conv, BN), ReLU, `* mask`.  The books are
    built on the level's device: the 1x1x1 book is the identity on live
    rows, the 3x3x3 book `sparse.subm_rules` unless the caller gives it.
    Its convs run kernels B / C (the 3x3x3 one by `loads`)."""

    expansion = 4

    def __init__(self, inplanes, planes):
        super().__init__()
        out = planes * self.expansion
        one = dict(kernel=(1, 1, 1), padding=(0, 0, 0))
        self.conv1 = SparseConv3d(inplanes, planes, **one)
        self.bn1 = BatchNorm(planes)
        self.conv2 = SparseConv3d(planes, planes)
        self.bn2 = BatchNorm(planes)
        self.conv3 = SparseConv3d(planes, out, **one)
        self.bn3 = BatchNorm(out)
        self.downsample = (nn.Sequential(SparseConv3d(inplanes, out, **one),
                                         BatchNorm(out))
                           if inplanes != out else None)

    def forward(self, level, book=None, compute_dtype=None, loads=sparse.ROWS):
        """:param book: the level's 3x3x3 subm book (B, V, 27), or None to
        build it here"""
        mask = level.mask[..., None].to(level.features.dtype)
        one = sparse.subm_rules(level, (1, 1, 1))
        book = sparse.subm_rules(level) if book is None else book
        out = level
        for conv, bn, rules in ((self.conv1, self.bn1, one),
                                (self.conv2, self.bn2, book),
                                (self.conv3, self.bn3, one)):
            out = conv(out, rules, compute_dtype, loads)
            f = bn(out.features, out.mask)
            if conv is not self.conv3:
                f = torch.relu(f)
            out = out._replace(features=f * mask)
        identity = level.features
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv(level, one, compute_dtype, loads).features,
                          level.mask)
        return out._replace(
            features=torch.relu(out.features + identity) * mask)


class UNetV2(BackBone8x):
    """Part-A²'s sparse UNet (`pcdet_tpu.models.backbones3d.UNetV2`, the
    reference's rpn_unet.py UNetV2): BackBone8x's encoder and BEV, then a
    decoder of four UR blocks back to the input level's sites, and the
    per-voxel segmentation and part heads.

    A UR block at level n (`ur_block`): `conv_up_t{n}` (a SparseBasicBlock
    on the encoder's level n), its output beside the level below's
    (channels [bottom, lateral]), `conv_up_m{n}` (a subm conv over both),
    plus the concatenation's channels summed in pairs; then `inv_conv{n}`,
    the inverse of the strided conv that made level n (n = 4, 3, 2), or
    `conv5` (a subm conv, n = 1).  The decoder's subm convs run over the
    encoder's subm books of their level and share its selectors; each
    inverse conv runs over the transpose of its strided conv's book
    (`inverse_books`), and its feature gradient over that conv's own
    forward book.  That makes 28 sparse convs a batch, 27 of them 3 wide in
    x, all by `loads.fwd` but conv_out.
    """

    UP = ((4, 64, 64, 'spconv4', (0, 1, 1)), (3, 64, 32, 'spconv3', (1, 1, 1)),
          (2, 32, 16, 'spconv2', (1, 1, 1)), (1, 16, 16, None, None))

    def __init__(self, num_input_features=4, last_pad=(0, 0, 0),
                 loads=None):
        super().__init__(num_input_features, last_pad, loads)
        for lvl, planes, out, _, pad in self.UP:
            setattr(self, 'conv_up_t%d' % lvl, SparseBasicBlock(planes))
            setattr(self, 'conv_up_m%d' % lvl,
                    SpConvBNReLU(2 * planes, planes))
            if pad is not None:
                setattr(self, 'inv_conv%d' % lvl, SpConvBNReLU(
                    planes, out, stride=(2, 2, 2), padding=pad, subm=False,
                    inverse=True))
        self.conv5 = nn.Sequential(SpConvBNReLU(16, 16))
        self.seg_cls_layer = nn.Linear(16, 1)
        self.seg_reg_layer = nn.Linear(16, 3)

    def inverse_books(self, books, fine_levels, shared):
        """Per strided book key, what its inverse conv takes: `rules_t`,
        the transposed book over its fine level's live sites, and under
        window `loads.fwd` its selectors (their dropped taps in
        `xwin_clamped[key + '_inv']`) and, where a backward will run, the
        strided conv's own forward selectors from `shared`, which its
        feature gradient reads."""
        out = {}
        backward = self.training and torch.is_grad_enabled()
        for key, fine in zip(('spconv2', 'spconv3', 'spconv4'), fine_levels):
            rules_t = sparse.inverse_rules(books[key][4], fine.mask)
            out[key] = {'rules_t': rules_t}
            if self.loads.fwd != 'rows':
                base, sel, self.xwin_clamped[key + '_inv'] = \
                    sparse.xwin_selectors(rules_t, books[key][4].shape[1])
                out[key]['xwin'] = (base, sel)
                if backward:
                    out[key]['bwd_xwin'] = shared[key]['xwin']
        return out

    def ur_block(self, lvl, lateral, bottom, book, compute_dtype, shared):
        """UR block `lvl` up to its merge: conv_up_t, the concatenation,
        conv_up_m plus the channel reduction (rpn_unet.py:414-436)."""
        t = getattr(self, 'conv_up_t%d' % lvl)(lateral, book, compute_dtype,
                                               self.loads, **shared)
        cat = torch.cat([bottom.features, t.features], dim=-1)
        m = getattr(self, 'conv_up_m%d' % lvl)(
            t._replace(features=cat), book, compute_dtype, self.loads,
            **shared)
        b, v, c = cat.shape
        return m._replace(features=m.features
                          + cat.reshape(b, v, c // 2, 2).sum(-1))

    def forward(self, level, books, compute_dtype=None):
        """:return: BEV (B, H, W, 128 * D) f32, the strided convs' drops
            (as `BackBone8x.forward`), and at the input level's sites
            {'u_seg_preds': (B, V, 1), 'u_reg_preds': (B, V, 3) raw,
            'seg_features': (B, V, 16)}"""
        cd = compute_dtype
        shared = self.shared_books(books, level.features.shape[1])
        levels, out, overflow = self.encode(level, books, cd, shared)
        inv = self.inverse_books(books, levels[:3], shared)
        x = levels[3]
        for lvl, _, _, key, _ in self.UP:
            sk = 'subm%d' % lvl
            x = self.ur_block(lvl, levels[lvl - 1], x, books[sk], cd,
                              shared[sk])
            if key is None:
                x = self.conv5[0](x, books[sk], cd, self.loads, **shared[sk])
            else:
                x = getattr(self, 'inv_conv%d' % lvl)(
                    x, books[key], cd, self.loads, target=levels[lvl - 2],
                    **inv[key])
        f = x.features
        return self.to_bev(out), overflow, {
            'u_seg_preds': self.seg_cls_layer(f),
            'u_reg_preds': self.seg_reg_layer(f), 'seg_features': f}


# the reference's UNetV0 is UNetV2 layer for layer (`pcdet_tpu.models.
# backbones3d.UNetV0`)
UNetV0 = UNetV2
