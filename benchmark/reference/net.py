"""Plain PyTorch forward of SECOND and PointPillar from a parameter dict.

The parameters are a dict keyed as the port's modules name them (so one
set of weights, made by the benchmark, goes to both sides): SECOND's
sparse encoder under `rpn_net.` (spconv's layout, (kz, ky, kx, Cin,
Cout)), PointPillar's PFN under `vfe.pfn_layers.0.`, and RPNV2 under
`rpn_head.`.  The architecture follows the configuration:

* SECOND: mean of each voxel's points; subm 4->16, subm 16; three stages
  of a stride-2 conv and two subm convs (32, 64, 64 channels; the third
  pads z by 0); a (3, 1, 1) stride (2, 1, 1) conv to 128; each conv then
  BatchNorm (eps 1e-3) and ReLU; the sites densified into a BEV of 128 * D
  channels (channel c * D + d).
* PointPillar: each point decorated with its offsets from its pillar's
  mean and from the pillar's centre (10 features, zero on padded slots),
  Linear (no bias) -> BN -> ReLU -> max over all point slots; the pillars
  scattered into a (ny, nx) canvas.
* RPNV2: per block a zero pad of 1, a 3x3 conv at the block's stride, then
  `layer_num` 3x3 convs, each followed by BN and ReLU; a transposed conv
  (kernel = stride) -> BN -> ReLU per block; the upsampled maps
  concatenated; 1x1 heads (box, class, direction) with biases.

`prec` (`Precision`) rounds the inputs and weights of the conv stacks
(the sparse convs, the RPN blocks and deblocks) and the RPN convs' outputs:
`F32` rounds nothing; `precision(section)` rounds as the configuration
states (bf16 in eval), `precision(section, lower=True)` one step below (the
control), and in the control the 1x1 heads' inputs and weights too (the
configuration runs them in f32 with cuDNN's TF32); the PFN stays float32.
BatchNorm runs in `eval` (running statistics), `train`
(batch statistics over the live rows) or `calib` (batch statistics,
recorded into `stats`: the benchmark's BN calibration).
"""
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from . import sparse
from .voxel import grid_size, voxelize

EPS = 1e-3


def identity(x):
    return x


def cast_quant(dtype):
    """Round to `dtype` and back (saturating a float8 type's range)."""
    if dtype is None:
        return identity
    finfo = torch.finfo(dtype)

    def q(x):
        return torch.clamp(x, finfo.min, finfo.max).to(dtype).to(x.dtype)
    return q


class Precision(NamedTuple):
    """Roundings: the sparse convs' inputs and weights, the RPN convs'
    inputs and weights, the RPN convs' outputs (a conv in bf16 returns
    bf16), the 1x1 heads' inputs and weights."""
    sparse: Callable = identity
    dense: Callable = identity
    dense_out: Callable = identity
    heads: Callable = identity


F32 = Precision()
STATED = {'bfloat16': torch.bfloat16, 'float32': None, 'tf32': None}
BELOW = {'bfloat16': torch.float8_e4m3fn, 'float32': torch.bfloat16,
         'tf32': torch.bfloat16}


def precision(section, lower=False):
    """The reference's roundings for a configuration's precision section
    (its `eval` or `train` part): as stated (bf16 where it says bf16; exact
    float32, TF32 off, for float32 and tf32), or for the control the next
    precision below (float8 e4m3 for bf16, bf16 for float32 and tf32)."""
    table = BELOW if lower else STATED
    sp, dn = table[section['sparse_conv']], table[section['rpn_conv']]
    return Precision(cast_quant(sp), cast_quant(dn),
                     cast_quant(None if dn is None else torch.bfloat16),
                     cast_quant(table[section['heads']]))


def resolve_caps(cap, level_caps, level_caps_frac, n=4):
    """Caps of the strided levels: an absolute cap, else a fraction of the
    input cap rounded up to a multiple of 256, else the input cap; each at
    most 4x the input cap."""
    caps = []
    for i in range(n):
        a = level_caps[i] if i < len(level_caps) else 0
        f = level_caps_frac[i] if i < len(level_caps_frac) else 0.0
        if a:
            caps.append(min(int(a), 4 * cap))
        elif f:
            caps.append(min(int(math.ceil(f * cap / 256) * 256), 4 * cap))
        else:
            caps.append(cap)
    return caps


SECOND_CONVS = (
    # name, cin, cout, kind, stride, padding (None: subm)
    ('conv_input.0', 4, 16, None),
    ('conv1.0.0', 16, 16, None),
    ('conv2.0.0', 16, 32, ((2, 2, 2), (1, 1, 1))),
    ('conv2.1.0', 32, 32, None), ('conv2.2.0', 32, 32, None),
    ('conv3.0.0', 32, 64, ((2, 2, 2), (1, 1, 1))),
    ('conv3.1.0', 64, 64, None), ('conv3.2.0', 64, 64, None),
    ('conv4.0.0', 64, 64, ((2, 2, 2), (0, 1, 1))),
    ('conv4.1.0', 64, 64, None), ('conv4.2.0', 64, 64, None),
    ('conv_out.0', 64, 128, 'out'),
)


def bn_name(conv_name):
    return conv_name[:-1] + '1'


class RefModel:
    """One configuration's plain model.

    :param cfg: the configuration as a nested dict (the YAML's keys)
    """

    def __init__(self, cfg):
        self.cfg = cfg
        data = cfg['DATA_CONFIG']
        self.kind = ('pointpillar' if cfg['MODEL']['NAME'] == 'PointPillar'
                     else 'second')
        self.voxel_size = list(data['VOXEL_GENERATOR']['VOXEL_SIZE'])
        self.pc_range = list(data['POINT_CLOUD_RANGE'])
        self.max_points = int(data['VOXEL_GENERATOR']['MAX_POINTS_PER_VOXEL'])
        self.caps = {'train': int(data['TRAIN']['MAX_NUMBER_OF_VOXELS']),
                     'eval': int(data['TEST']['MAX_NUMBER_OF_VOXELS'])}
        self.grid = grid_size(self.voxel_size, self.pc_range)   # nx, ny, nz
        self.num_class = len(cfg['CLASS_NAMES'])
        head = cfg['MODEL']['RPN']['RPN_HEAD']
        self.rpn = dict(head['ARGS'])
        self.num_anchors = 2 * self.num_class   # 1 size x 2 rotations each
        if self.kind == 'second':
            self.sparse_shape = (self.grid[2] + 1, self.grid[1], self.grid[0])
            vz = self.voxel_size[-1]
            self.last_pad = (0, 0, 0) if vz in [0.1, 0.2] else (1, 0, 0)
            self.bb = dict(cfg['MODEL']['RPN']['BACKBONE'].get('ARGS', {}))
            shape = self.sparse_shape
            for pad in ((1, 1, 1), (1, 1, 1), (0, 1, 1)):
                shape = sparse.out_shape(shape, (3, 3, 3), (2, 2, 2), pad)
            self.out_depth = sparse.out_shape(shape, (3, 1, 1), (2, 1, 1),
                                              self.last_pad)[0]
            self.bev_channels = 128 * self.out_depth
        else:
            self.pfn_filters = int(cfg['MODEL']['VFE']['ARGS']['num_filters']
                                   [-1])
            self.bev_channels = self.pfn_filters

    def level_caps(self, train):
        cap = self.caps['train' if train else 'eval']
        absolute = (self.bb.get('level_caps', (0, 0, 0)) if train
                    or not self.bb.get('level_caps_test')
                    else self.bb['level_caps_test'])
        return resolve_caps(cap, tuple(absolute),
                            tuple(self.bb.get('level_caps_frac', (0.,) * 4)))

    # ------------------------------------------------------------ weights --
    def spec(self):
        """[(name, shape, kind, fan_in)]: kind 'w' (weight), 'b' (bias),
        'bn' (a BatchNorm's weight, bias, running_mean, running_var,
        num_batches_tracked as five entries)."""
        out = []

        def bn(prefix, c):
            for k in ('weight', 'bias', 'running_mean', 'running_var'):
                out.append(('%s.%s' % (prefix, k), (c,), 'bn', 0))
            out.append(('%s.num_batches_tracked' % prefix, (), 'bn', 0))

        if self.kind == 'second':
            for name, cin, cout, kind in SECOND_CONVS:
                k = (3, 1, 1) if kind == 'out' else (3, 3, 3)
                out.append(('rpn_net.%s.weight' % name, (*k, cin, cout), 'w',
                            cin * math.prod(k)))
                bn('rpn_net.' + bn_name(name), cout)
        else:
            c_in = 10
            out.append(('vfe.pfn_layers.0.linear.weight',
                        (self.pfn_filters, c_in), 'w', c_in))
            bn('vfe.pfn_layers.0.norm', self.pfn_filters)
        a = self.rpn
        c_in = self.bev_channels
        for i, n in enumerate(a['layer_nums']):
            nf = a['num_filters'][i]
            for j in range(n + 1):
                cin = c_in if j == 0 else nf
                out.append(('rpn_head.blocks.%d.%d.weight' % (i, 1 + 3 * j),
                            (nf, cin, 3, 3), 'w', cin * 9))
                bn('rpn_head.blocks.%d.%d' % (i, 2 + 3 * j), nf)
            s, up = a['upsample_strides'][i], a['num_upsample_filters'][i]
            out.append(('rpn_head.deblocks.%d.0.weight' % i, (nf, up, s, s),
                        'w', up * s * s))
            bn('rpn_head.deblocks.%d.1' % i, up)
            c_in = nf
        c_head = sum(a['num_upsample_filters'])
        na = self.num_anchors
        for head, width in (('conv_box', na * 7),
                            ('conv_cls', na * self.num_class),
                            ('conv_dir_cls', na * 2)):
            out.append(('rpn_head.%s.weight' % head, (width, c_head, 1, 1),
                        'w', c_head))
            out.append(('rpn_head.%s.bias' % head, (width,), 'b', c_head))
        return out

    # ------------------------------------------------------------ forward --
    def bn(self, x, p, name, mode, stats, dims):
        shape = [1] * x.dim()
        shape[1 if x.dim() == 4 else -1] = -1
        w, b = p[name + '.weight'].view(shape), p[name + '.bias'].view(shape)
        if mode == 'eval':
            mean = p[name + '.running_mean'].view(shape)
            var = p[name + '.running_var'].view(shape)
        else:
            mean = x.mean(dim=dims, keepdim=True)
            var = torch.square(x - mean).mean(dim=dims, keepdim=True)
            if mode == 'calib':
                stats[name] = (mean.detach().flatten(), var.detach().flatten())
        return (x - mean) * torch.rsqrt(var + EPS) * w + b

    def backbone(self, p, vox, batch, mode, prec, stats, work, train):
        counts = torch.clamp(vox['num'], min=1).to(vox['points'].dtype)
        feats = vox['points'].sum(1) / counts[:, None]
        level = sparse.Level(vox['coords'], feats, self.sparse_shape, batch)
        caps = self.level_caps(train)
        dropped = {}
        stage = 0
        for name, _, _, kind in SECOND_CONVS:
            w = p['rpn_net.%s.weight' % name]
            if kind is None:
                level = sparse.subm_conv(level, w, prec.sparse, work, name)
            else:
                stride, pad = (((2, 1, 1), self.last_pad) if kind == 'out'
                               else kind)
                level, dropped[name] = sparse.strided_conv(
                    level, w, stride, pad, caps[stage], prec.sparse, work,
                    name)
                stage += 1
            f = self.bn(level.feats, p, 'rpn_net.' + bn_name(name), mode,
                        stats, [0])
            level = sparse.Level(level.coords, torch.relu(f), level.shape,
                                 batch)
        return sparse.to_bev(level), dropped

    def pillars(self, p, vox, batch, mode, stats):
        pts = vox['points']                               # (N, P, 4)
        n = torch.clamp(vox['num'], min=1).to(pts.dtype)[:, None, None]
        mean = pts[..., :3].sum(1, keepdim=True) / n
        vx, vy, vz = self.voxel_size
        lo = self.pc_range
        c = vox['coords'].to(pts.dtype)                   # b, z, y, x
        centre = torch.stack([c[:, 3] * vx + vx / 2 + lo[0],
                              c[:, 2] * vy + vy / 2 + lo[1],
                              c[:, 1] * vz + vz / 2 + lo[2]], -1)
        feats = torch.cat([pts, pts[..., :3] - mean,
                           pts[..., :3] - centre[:, None]], -1)
        slot = torch.arange(pts.shape[1], device=pts.device)
        live = (slot[None] < vox['num'][:, None]).to(pts.dtype)
        feats = feats * live[..., None]
        h = feats @ p['vfe.pfn_layers.0.linear.weight'].t()    # (N, P, C)
        h = torch.relu(self.bn(h, p, 'vfe.pfn_layers.0.norm', mode, stats,
                               [0, 1]))
        h = h.amax(1)
        nx, ny = self.grid[0], self.grid[1]
        canvas = h.new_zeros((batch, ny, nx, h.shape[1]))
        b, y, x = vox['coords'][:, 0], vox['coords'][:, 2], vox['coords'][:, 3]
        canvas = canvas.index_put((b, y, x), h)
        return canvas.permute(0, 3, 1, 2)

    def rpn_forward(self, p, x, mode, prec, stats):
        a = self.rpn
        ups = []
        for i, n in enumerate(a['layer_nums']):
            x = F.pad(x, (1, 1, 1, 1))
            for j in range(n + 1):
                pre = 'rpn_head.blocks.%d.' % i
                x = prec.dense_out(F.conv2d(
                    prec.dense(x), prec.dense(p[pre + '%d.weight' % (1 + 3 * j)]),
                    stride=a['layer_strides'][i] if j == 0 else 1,
                    padding=0 if j == 0 else 1))
                x = torch.relu(self.bn(x, p, pre + str(2 + 3 * j), mode,
                                       stats, [0, 2, 3]))
            s = a['upsample_strides'][i]
            u = prec.dense_out(F.conv_transpose2d(
                prec.dense(x), prec.dense(p['rpn_head.deblocks.%d.0.weight' % i]),
                stride=s))
            ups.append(torch.relu(self.bn(u, p, 'rpn_head.deblocks.%d.1' % i,
                                          mode, stats, [0, 2, 3])))
        x = torch.cat(ups, 1)
        out = {}
        for head in ('conv_box', 'conv_cls', 'conv_dir_cls'):
            y = F.conv2d(prec.heads(x), prec.heads(
                p['rpn_head.%s.weight' % head]), p['rpn_head.%s.bias' % head])
            out[head] = y.permute(0, 2, 3, 1)                  # NHWC
        b = x.shape[0]
        return {'box': out['conv_box'].reshape(b, -1, 7),
                'cls': out['conv_cls'].reshape(b, -1, self.num_class),
                'dir': out['conv_dir_cls'].reshape(b, -1, 2)}

    def forward(self, p, points, mask, train=False, mode=None, prec=F32,
                stats=None, work=None):
        """Scans -> head outputs: box (B, A, 7), cls (B, A, C), dir (B, A,
        2) over the flat anchors, with `dropped` (voxelizer and levels).

        :param mode: BatchNorm mode; default 'train' when `train`, else
            'eval'.  `train` picks the caps (TRAIN or TEST voxels and
            levels)."""
        mode = mode or ('train' if train else 'eval')
        batch = points.shape[0]
        vox = voxelize(points, mask, self.voxel_size, self.pc_range,
                       self.max_points,
                       self.caps['train' if train else 'eval'])
        dropped = {'voxelizer': vox['dropped']}
        if self.kind == 'second':
            bev, lv = self.backbone(p, vox, batch, mode, prec, stats, work,
                                    train)
            dropped.update(lv)
        else:
            bev = self.pillars(p, vox, batch, mode, stats)
        out = self.rpn_forward(p, bev, mode, prec, stats)
        out['dropped'] = dropped
        out['num_voxels'] = len(vox['coords'])
        return out
