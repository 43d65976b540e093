"""pcdet_tpu (flax) PointPillar / SECOND / Part-A² variables -> this port's
state_dict.

The inverse of `pcdet_tpu.train.torch_import` for PointPillar, SECOND and
Part-A² (`map_unetv2`, `map_rcnn`).  Keys follow the reference PCDet
state_dict (`vfe.pfn_layers.{i}.linear`, `rpn_net.conv_input.0`,
`rpn_net.conv{1..4}.{j}.0`, `rpn_net.conv_out.0`, `rpn_head.blocks.{i}.{1+3j}`,
`rpn_head.deblocks.{i}.0`, `rpn_head.conv_*`; Part-A²'s
`rpn_net.conv_up_t{n}`, `conv_up_m{n}`, `inv_conv{n}`, `conv5.0`,
`seg_{cls,reg}_layer` and `rcnn_net.*`; a SparseBottleneck's `conv1`
.. `conv3`, `bn1` .. `bn3`, `downsample.{0,1}`), so the same dict also
loads into the reference model.  Layout transforms:
  flax Dense kernel (in, out)            -> Linear weight (out, in)
  flax conv kernel HWIO (kh, kw, in, out) -> Conv2d weight OIHW (RPNV2's
      convs and PointPillar's `bev_seg_head`: Conv_0 / Conv_1 / Conv_2 ->
      conv1 / conv2 / conv_out)
  flax deconv kernel (kh, kw, in, out)   -> ConvTranspose2d (in, out, kh, kw)
  flax sparse kernel (K, in, out)        -> spconv (k0, k1, k2, in, out)
  flax RCNN dense conv (3, 3, 3, in, out) -> the same (spconv's layout)
  flax RCNN FC kernel (in, out)          -> Conv1d weight (out, in, 1); the
      first shared FC's rows from grid-major (X, Y, Z, C) to the
      reference's channel-major (C, X, Y, Z)
  BN scale / bias + batch_stats mean / var
      -> weight / bias / running_mean / running_var (+ num_batches_tracked 0)
An RCNN FC followed by BN has no bias in the reference; its flax bias b
moves into the BN, running_mean - b (exact in eval; batch statistics
cancel it), so `torch_import`, which reads a zero bias, gives it back
where b is 0, as a flax init leaves it.
A gradient tree has the params' structure and transforms like them:
`state_dict_from_flax({'params': grads}, ...)` (no batch_stats) maps it onto
the port's parameter names, with no buffers.

`load_checkpoint` / `model_state` read such a state_dict back from a `.pth`
(`train.checkpoint`'s, or a reference one).
"""
import numpy as np
import torch


def load_checkpoint(path, device='cpu'):
    """The payload dict of a `.pth`, its tensors on `device`."""
    return torch.load(path, map_location=device, weights_only=True)


def model_state(payload):
    """A payload's `model_state`; a bare state_dict is taken as one."""
    return payload.get('model_state', payload)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _bn(sd, key, params, stats):
    sd[key + '.weight'] = _t(params['scale'])
    sd[key + '.bias'] = _t(params['bias'])
    if stats is None:
        return
    sd[key + '.running_mean'] = _t(stats['mean'])
    sd[key + '.running_var'] = _t(stats['var'])
    sd[key + '.num_batches_tracked'] = torch.tensor(0, dtype=torch.long)


def _sub(tree, key):
    """tree[key] ({} where absent), or None for a missing batch_stats tree."""
    return None if tree is None else tree.get(key, {})


def _conv(sd, key, params):
    sd[key + '.weight'] = _t(np.transpose(params['kernel'], (3, 2, 0, 1)))
    if 'bias' in params:
        sd[key + '.bias'] = _t(params['bias'])


# the fork's BEV segmentation head: flax Conv_0..2 -> these convs
BEV_SEG_CONVS = ('conv1', 'conv2', 'conv_out')

# BackBone8x's sparse convs: flax module -> (reference prefix, kernel)
_BACKBONE8X = [('conv_input', 'rpn_net.conv_input', (3, 3, 3)),
               ('conv1_0', 'rpn_net.conv1.0', (3, 3, 3))] + [
    ('conv%d_%d' % (lvl, j), 'rpn_net.conv%d.%d' % (lvl, j), (3, 3, 3))
    for lvl in (2, 3, 4) for j in range(3)] + [
    ('conv_out', 'rpn_net.conv_out', (3, 1, 1))]


def state_dict_from_flax(variables, layer_nums, rcnn_cfg=None):
    """:param variables: {'params': ..., 'batch_stats': ...} of
        `pcdet_tpu.models.pointpillar.PointPillarNet`,
        `pcdet_tpu.models.second.SECONDNetModule`,
        `pcdet_tpu.models.parta2.PartA2Net` or a
        `pcdet_tpu.models.backbones3d.SparseBottleneck` (numpy or jax
        arrays)
    :param layer_nums: RPNV2's `layer_nums` (flax numbers its ConvBNReLUs
        across blocks, torch within each block)
    :param rcnn_cfg: Part-A²'s `MODEL.RCNN` (its head, FC stacks, dropout
        and pool size), required for its variables
    :return: dict[str, Tensor] for the port module's `load_state_dict`;
        parameters only when `variables` has no 'batch_stats'
    """
    params, stats = variables['params'], variables.get('batch_stats')
    sd = {}
    if 'kernel3' in params:
        return bottleneck_state_dict(sd, '', params, stats)
    if 'stage1' in params:
        return _parta2(sd, params, stats, layer_nums, rcnn_cfg)
    if 'backbone_3d' in params:
        bp, bs = params['backbone_3d'], _sub(stats, 'backbone_3d')
        for name, key, kernel in _BACKBONE8X:
            _spconv(sd, key + '.0.weight', kernel, bp[name])
            _bn(sd, key + '.1', bp[name]['TorchBatchNorm_0'],
                _sub(_sub(bs, name), 'TorchBatchNorm_0'))
        _rpnv2(sd, params, stats, layer_nums)
        return sd
    vp, vs = params['vfe'], _sub(stats, 'vfe')
    for i in range(len(vp)):
        name = 'PFNLayer_%d' % i
        lin = vp[name]['TorchLinear_0']
        key = 'vfe.pfn_layers.%d' % i
        sd[key + '.linear.weight'] = _t(np.transpose(lin['kernel']))
        if 'bias' in lin:
            sd[key + '.linear.bias'] = _t(lin['bias'])
        if 'TorchBatchNorm_0' in vp[name]:
            _bn(sd, key + '.norm', vp[name]['TorchBatchNorm_0'],
                _sub(_sub(vs, name), 'TorchBatchNorm_0'))
    _rpnv2(sd, params, stats, layer_nums)
    if 'bev_seg_head' in params:
        for name, key in zip(('Conv_0', 'Conv_1', 'Conv_2'), BEV_SEG_CONVS):
            _conv(sd, 'bev_seg_head.' + key, params['bev_seg_head'][name])
    return sd


def _spconv(sd, key, kernel, params, name='kernel'):
    w = np.asarray(params[name])
    sd[key] = _t(w.reshape(*kernel, *w.shape[1:]))


def bottleneck_state_dict(sd, prefix, params, stats):
    """`pcdet_tpu.models.backbones3d.SparseBottleneck`'s variables (kernel1
    .. kernel3, kernel_down; bn1 .. bn3, bn_down) -> `models.backbones3d.
    SparseBottleneck`'s keys under `prefix` (conv1 .. conv3 with bn1 ..
    bn3; downsample.0 / .1) in `sd`, which it returns."""
    one, three = (1, 1, 1), (3, 3, 3)
    for i, kernel in ((1, one), (2, three), (3, one)):
        _spconv(sd, '%sconv%d.weight' % (prefix, i), kernel, params,
                'kernel%d' % i)
        _bn(sd, '%sbn%d' % (prefix, i), params['bn%d' % i],
            _sub(stats, 'bn%d' % i))
    if 'kernel_down' in params:
        _spconv(sd, prefix + 'downsample.0.weight', one, params,
                'kernel_down')
        _bn(sd, prefix + 'downsample.1', params['bn_down'],
            _sub(stats, 'bn_down'))
    return sd


def _parta2(sd, params, stats, layer_nums, rcnn_cfg):
    if rcnn_cfg is None:
        raise ValueError('Part-A2 variables need rcnn_cfg (MODEL.RCNN)')
    p1, s1 = params['stage1'], _sub(stats, 'stage1')
    up, us = p1['unet'], _sub(s1, 'unet')
    k3 = (3, 3, 3)

    def block(name, key, kernel=k3):
        _spconv(sd, key + '.0.weight', kernel, up[name])
        _bn(sd, key + '.1', up[name]['TorchBatchNorm_0'],
            _sub(_sub(us, name), 'TorchBatchNorm_0'))

    for name, key, kernel in _BACKBONE8X:
        block(name, key, kernel)
    for lvl in (4, 3, 2, 1):
        name, key = 'up%d_t' % lvl, 'rpn_net.conv_up_t%d' % lvl
        for i in (1, 2):
            _spconv(sd, '%s.conv%d.weight' % (key, i), k3, up[name],
                    'kernel%d' % i)
            _bn(sd, '%s.bn%d' % (key, i), up[name]['bn%d' % i],
                _sub(_sub(us, name), 'bn%d' % i))
        block('up%d_m' % lvl, 'rpn_net.conv_up_m%d' % lvl)
        block('up%d_inv' % lvl, 'rpn_net.inv_conv%d' % lvl if lvl > 1
              else 'rpn_net.conv5.0')
    for name in ('seg_cls_layer', 'seg_reg_layer'):
        sd['rpn_net.%s.weight' % name] = _t(np.transpose(up[name]['kernel']))
        sd['rpn_net.%s.bias' % name] = _t(up[name]['bias'])
    _rpnv2(sd, p1, s1, layer_nums)
    _rcnn(sd, params['rcnn'], _sub(stats, 'rcnn'), rcnn_cfg)
    return sd


def _fc(sd, key, params, stats, bn=True, rows=None):
    """One FCBlock -> pt_utils.Conv1d at `key` (conv at .conv, BN at
    .bn.bn); `rows` reorders the kernel's input rows first."""
    w = np.asarray(params['kernel'])
    if rows is not None:
        w = rows(w)
    sd[key + '.conv.weight'] = _t(np.transpose(w)[..., None])
    b = np.asarray(params['bias'], np.float32)
    if not bn:
        sd[key + '.conv.bias'] = _t(b)
        return
    bn_stats = _sub(stats, 'TorchBatchNorm_0')
    if bn_stats is not None:      # the bias moves into the running mean
        bn_stats = dict(bn_stats, mean=np.asarray(bn_stats['mean']) - b)
    _bn(sd, key + '.bn.bn', params['TorchBatchNorm_0'], bn_stats)


def _rcnn(sd, rp, rs, rcnn_cfg):
    """SpConvRCNN / FCRCNN -> rcnn_net.* (`torch_import.map_rcnn`'s
    inverse)."""
    dp = float(rcnn_cfg.DP_RATIO)
    shared_fc = tuple(rcnn_cfg.SHARED_FC)
    convs = ['conv_part_0', 'conv_part_1', 'conv_rpn_0', 'conv_rpn_1']
    keys = ['conv_part.0', 'conv_part.1', 'conv_rpn.0', 'conv_rpn.1']
    grid = int(rcnn_cfg.ROI_AWARE_POOL_SIZE)
    if rcnn_cfg.NAME == 'SpConvRCNN':
        convs += ['conv_down_%d' % i for i in range(4)]
        keys += ['conv_down.%d' % i for i in (0, 1, 3, 4)]   # .2: the pool
        grid //= 2
    for name, key in zip(convs, keys):
        sd['rcnn_net.%s.0.weight' % key] = _t(rp[name]['kernel'])
        _bn(sd, 'rcnn_net.%s.1' % key, rp[name]['TorchBatchNorm_0'],
            _sub(_sub(rs, name), 'TorchBatchNorm_0'))

    def channel_major(w):                  # (X Y Z C, out) -> (C X Y Z, out)
        out = w.shape[1]
        return (w.reshape(grid, grid, grid, shared_fc[0], out)
                .transpose(3, 0, 1, 2, 4).reshape(-1, out))

    n_sh = len(shared_fc) - 1
    idx = 0
    for i in range(n_sh):
        name = 'shared_fc_%d' % i
        _fc(sd, 'rcnn_net.shared_fc_layer.%d' % idx, rp[name], _sub(rs, name),
            rows=channel_major if i == 0 else None)
        idx += 1 + (i != n_sh - 1 and dp > 0)
    for tower, fcs, fname, outname in (
            ('cls_layer', rcnn_cfg.CLS_FC, 'cls_fc_%d', 'cls_out'),
            ('reg_layer', rcnn_cfg.REG_FC, 'reg_fc_%d', 'reg_out')):
        idx = 0
        for i in range(len(fcs)):
            _fc(sd, 'rcnn_net.%s.%d' % (tower, idx), rp[fname % i],
                _sub(rs, fname % i))
            idx += 1 + (i == 0 and dp >= 0)
        _fc(sd, 'rcnn_net.%s.%d' % (tower, idx), rp[outname], None, bn=False)


def _rpnv2(sd, params, stats, layer_nums):
    rp, rs = params['rpn_head'], _sub(stats, 'rpn_head')
    conv_i = 0
    for i, ln in enumerate(layer_nums):
        for j in range(ln + 1):
            name = 'ConvBNReLU_%d' % conv_i
            key = 'rpn_head.blocks.%d' % i
            _conv(sd, '%s.%d' % (key, 1 + 3 * j), rp[name]['TorchConv_0'])
            if 'TorchBatchNorm_0' in rp[name]:
                _bn(sd, '%s.%d' % (key, 2 + 3 * j), rp[name]['TorchBatchNorm_0'],
                    _sub(_sub(rs, name), 'TorchBatchNorm_0'))
            conv_i += 1
        name = 'DeconvBNReLU_%d' % i
        key = 'rpn_head.deblocks.%d' % i
        deconv = rp[name]['TorchConvTranspose_0']
        sd[key + '.0.weight'] = _t(np.transpose(deconv['kernel'], (2, 3, 0, 1)))
        if 'bias' in deconv:
            sd[key + '.0.bias'] = _t(deconv['bias'])
        if 'TorchBatchNorm_0' in rp[name]:
            _bn(sd, key + '.1', rp[name]['TorchBatchNorm_0'],
                _sub(_sub(rs, name), 'TorchBatchNorm_0'))
    for head in ('conv_box', 'conv_cls', 'conv_dir_cls'):
        if head in rp:
            _conv(sd, 'rpn_head.' + head, rp[head])
