"""pcdet_tpu (flax) PointPillar / SECOND variables -> this port's state_dict.

The inverse of `pcdet_tpu.train.torch_import` for PointPillar and SECOND.
Keys follow the reference PCDet state_dict (`vfe.pfn_layers.{i}.linear`,
`rpn_net.conv_input.0`, `rpn_net.conv{1..4}.{j}.0`, `rpn_net.conv_out.0`,
`rpn_head.blocks.{i}.{1+3j}`, `rpn_head.deblocks.{i}.0`, `rpn_head.conv_*`),
so the same dict also loads into the reference model.  Layout transforms:
  flax Dense kernel (in, out)            -> Linear weight (out, in)
  flax conv kernel HWIO (kh, kw, in, out) -> Conv2d weight OIHW
  flax deconv kernel (kh, kw, in, out)   -> ConvTranspose2d (in, out, kh, kw)
  flax sparse kernel (K, in, out)        -> spconv (k0, k1, k2, in, out)
  BN scale / bias + batch_stats mean / var
      -> weight / bias / running_mean / running_var (+ num_batches_tracked 0)
A gradient tree has the params' structure and transforms like them:
`state_dict_from_flax({'params': grads}, ...)` (no batch_stats) maps it onto
the port's parameter names, with no buffers.
"""
import numpy as np
import torch


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


# BackBone8x's sparse convs: flax module -> (reference prefix, kernel)
_BACKBONE8X = [('conv_input', 'rpn_net.conv_input', (3, 3, 3)),
               ('conv1_0', 'rpn_net.conv1.0', (3, 3, 3))] + [
    ('conv%d_%d' % (lvl, j), 'rpn_net.conv%d.%d' % (lvl, j), (3, 3, 3))
    for lvl in (2, 3, 4) for j in range(3)] + [
    ('conv_out', 'rpn_net.conv_out', (3, 1, 1))]


def state_dict_from_flax(variables, layer_nums):
    """:param variables: {'params': ..., 'batch_stats': ...} of
        `pcdet_tpu.models.pointpillar.PointPillarNet` or
        `pcdet_tpu.models.second.SECONDNetModule` (numpy or jax arrays)
    :param layer_nums: RPNV2's `layer_nums` (flax numbers its ConvBNReLUs
        across blocks, torch within each block)
    :return: dict[str, Tensor] for the port module's `load_state_dict`;
        parameters only when `variables` has no 'batch_stats'
    """
    params, stats = variables['params'], variables.get('batch_stats')
    sd = {}
    if 'backbone_3d' in params:
        bp, bs = params['backbone_3d'], _sub(stats, 'backbone_3d')
        for name, key, kernel in _BACKBONE8X:
            w = np.asarray(bp[name]['kernel'])
            sd[key + '.0.weight'] = _t(w.reshape(*kernel, *w.shape[1:]))
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
    return sd


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
