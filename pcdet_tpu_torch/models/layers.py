"""Building blocks with the reference's parameter names and BN semantics.

Twins of `pcdet_tpu.models.layers`: BatchNorm with eps 1e-3 and momentum
0.01 normalises by its running statistics in eval and by the batch's in
training (`TorchBatchNorm`), optionally over the rows a mask keeps: over
the whole batch, per block of the batch (`BN_GROUPS`), or over the whole
batch of every rank of a process group (`--sync_bn`), as
`set_batch_norm` sets on a module tree.

Parameters keep PyTorch's own layouts (Linear (out, in), Conv2d OIHW,
ConvTranspose2d (in, out, kh, kw)), so a reference state_dict loads as it is.
`init_weights` fills them from an explicit `torch.Generator` with torch's
default distribution, U(-1/sqrt(fan_in), 1/sqrt(fan_in)).

``compute_dtype`` (bfloat16 for the shipped eval config) casts activations
and weights for the convolution in eval mode only; training runs f32, as
`pcdet_tpu`'s RPNV2 does (`compute_dtype_test`).  JAX keeps an f32 result
there (`preferred_element_type`); cuDNN and torch return bf16, so the port
rounds once more per conv before its f32 BatchNorm.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import ddp


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (channels-last) or axis 1 (NCHW).

    Training (`pcdet_tpu.models.layers.TorchBatchNorm`): normalise by the
    batch mean and biased variance over every axis but the channel's, or
    over the rows `mask` keeps (a mask of every axis but the channel's, as
    a (B, V) mask of a channels-last (B, V, C) input: the live voxels of
    the whole batch); the running statistics take momentum 0.01 of the
    mean and of the unbiased variance var * n / (n - 1).  Written out by
    hand: F.batch_norm takes no mask.  `mask` is ignored in eval.

    Where the statistics come from (`set_batch_norm`):
      - `groups` > 1 (JAX's BN_GROUPS, per-device BN in one process): per
        contiguous block of the leading axis, each block its own n; one
        group where the input has fewer than 2 axes or a leading axis that
        `groups` does not divide; the running statistics take group 0's
        (DDP's rank 0);
      - `process_group` of more than one rank (`--sync_bn`, JAX's
        BN_GROUPS 1 over a sharded batch): the mean from the summed
        (sum of x w, n) of every rank, then the variance from the summed
        sum of (x - mean)^2 w, both through the differentiable all-reduce.
    """

    def __init__(self, features, eps=1e-3, momentum=0.01, channel_dim=-1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.channel_dim = channel_dim
        self.groups = 1
        self.process_group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))
        self.register_buffer('num_batches_tracked',
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x, mask=None):
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        if not self.training:
            mean = self.running_mean.view(shape)
            inv = torch.rsqrt(self.running_var + self.eps).view(shape)
            return ((x - mean) * inv * self.weight.view(shape)
                    + self.bias.view(shape))
        if (self.groups > 1 and x.dim() >= 2
                and x.shape[0] % self.groups == 0):
            return self._grouped(x, mask, shape)
        dims = [d for d in range(x.dim()) if d != self.channel_dim % x.dim()]
        group = self.process_group
        if ddp.world_size(group) > 1:
            mean, var, n = self._synced(x, mask, dims, shape, group)
        elif mask is None:
            n = torch.full((), float(x.numel() // x.shape[self.channel_dim]),
                           dtype=x.dtype, device=x.device)
            mean = x.mean(dim=dims)
            var = torch.square(x - mean.view(shape)).mean(dim=dims)
        else:
            w = mask.to(x.dtype)[..., None]
            n = torch.clamp(w.sum(), min=1.0)
            mean = (x * w).sum(dim=dims) / n
            var = (torch.square(x - mean.view(shape)) * w).sum(dim=dims) / n
        self._track(mean, var, n)
        y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return y * self.weight.view(shape) + self.bias.view(shape)

    @torch.no_grad()
    def _track(self, mean, var, n):
        m = self.momentum
        unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        self.num_batches_tracked += 1

    def _synced(self, x, mask, dims, shape, group):
        """Mean, biased variance and n over every rank's batch: two passes,
        as JAX's statistics over a sharded batch."""
        if mask is None:
            # filled on the device: a host tensor's copy would wait on it
            local_n = torch.full((), float(x.numel() // x.shape[
                self.channel_dim]), dtype=x.dtype, device=x.device)
            s = x.sum(dim=dims)
            w = None
        else:
            w = mask.to(x.dtype)[..., None]
            local_n = w.sum()
            s = (x * w).sum(dim=dims)
        total = ddp.all_reduce_sum(torch.cat([s, local_n[None]]), group)
        n = total[-1].detach()
        if w is not None:
            n = torch.clamp(n, min=1.0)
        mean = total[:-1] / n
        d2 = torch.square(x - mean.view(shape))
        if w is not None:
            d2 = d2 * w
        var = ddp.all_reduce_sum(d2.sum(dim=dims), group) / n
        return mean, var, n

    def _grouped(self, x, mask, shape):
        """Statistics per contiguous block of the leading axis."""
        g = self.groups
        xg = x.reshape((g, x.shape[0] // g) + tuple(x.shape[1:]))
        cdim = self.channel_dim % x.dim() + 1
        dims = [d for d in range(1, xg.dim()) if d != cdim]
        gshape = [1] * xg.dim()
        gshape[0], gshape[cdim] = g, -1
        if mask is None:
            n = torch.full((g,), float(xg[0].numel() // x.shape[
                self.channel_dim]), dtype=x.dtype, device=x.device)
            mean = xg.mean(dim=dims)                               # (g, C)
            var = torch.square(xg - mean.view(gshape)).mean(dim=dims)
        else:
            w = mask.to(x.dtype).reshape(
                (g, x.shape[0] // g) + tuple(mask.shape[1:]))[..., None]
            n = torch.clamp(w.sum(dim=dims), min=1.0)[:, 0]       # (g,)
            mean = (xg * w).sum(dim=dims) / n[:, None]
            var = (torch.square(xg - mean.view(gshape)) * w).sum(
                dim=dims) / n[:, None]
        self._track(mean[0], var[0], n[0])
        y = (xg - mean.view(gshape)) * torch.rsqrt(var.view(gshape)
                                                   + self.eps)
        return (y.reshape(x.shape) * self.weight.view(shape)
                + self.bias.view(shape))


def set_batch_norm(module, groups=1, process_group=None):
    """Where every BatchNorm of `module` takes its training statistics:
    per block of `groups` of the batch (JAX's `set_bn_groups`), or over
    the ranks of `process_group` (sync BN; a group of one rank is the
    batch's own statistics).  Per module tree, not per process, so that one
    process can hold trainers of either kind."""
    if groups > 1 and ddp.world_size(process_group) > 1:
        raise ValueError('BN groups and a synced process group exclude each '
                         'other')
    for mod in module.modules():
        if isinstance(mod, BatchNorm):
            mod.groups = max(int(groups), 1)
            mod.process_group = process_group


class TorchLinear(nn.Linear):
    """nn.Linear on (..., in) -> (..., out)."""


class TorchConv(nn.Conv2d):
    """nn.Conv2d (NCHW, any memory format) with an optional eval compute
    dtype."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, bias=True, compute_dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype is None or self.training:
            return super().forward(x)
        y = F.conv2d(x.to(self.compute_dtype),
                     self.weight.to(self.compute_dtype), None, self.stride,
                     self.padding).float()
        return y if self.bias is None else y + self.bias.view(1, -1, 1, 1)


class TorchConvTranspose(nn.ConvTranspose2d):
    """nn.ConvTranspose2d with kernel == stride (the only mode RPNV2 uses)."""

    def __init__(self, in_channels, out_channels, stride=2, bias=True,
                 compute_dtype=None):
        super().__init__(in_channels, out_channels, stride, stride=stride,
                         bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype is None or self.training:
            return super().forward(x)
        y = F.conv_transpose2d(x.to(self.compute_dtype),
                               self.weight.to(self.compute_dtype), None,
                               self.stride).float()
        return y if self.bias is None else y + self.bias.view(1, -1, 1, 1)


def _norm(features, use_norm):
    """BN over NCHW channels, or a parameterless stand-in that keeps the
    reference's module indices (its `Empty` when use_norm is off)."""
    return BatchNorm(features, channel_dim=1) if use_norm else nn.Identity()


class ConvBNReLU(nn.Sequential):
    """Conv -> BN -> ReLU (NCHW).  Its children splice into a larger
    Sequential (`nn.Sequential(pad, *ConvBNReLU(...), ...)`) to keep the
    reference's flat block indices."""

    def __init__(self, in_channels, features, kernel_size=3, stride=1,
                 padding=0, use_norm=True, compute_dtype=None):
        super().__init__(
            TorchConv(in_channels, features, kernel_size, stride, padding,
                      bias=not use_norm, compute_dtype=compute_dtype),
            _norm(features, use_norm), nn.ReLU())


class DeconvBNReLU(nn.Sequential):
    """ConvTranspose -> BN -> ReLU (NCHW); children at .0 / .1 / .2 as in
    the reference's deblocks."""

    def __init__(self, in_channels, features, stride=2, use_norm=True,
                 compute_dtype=None):
        super().__init__(
            TorchConvTranspose(in_channels, features, stride,
                               bias=not use_norm, compute_dtype=compute_dtype),
            _norm(features, use_norm), nn.ReLU())


def _fan_in(module):
    w = module.weight
    if hasattr(module, 'fan_in'):                # sparse convs: Cin * K
        return module.fan_in
    if isinstance(module, nn.ConvTranspose2d):
        return w.shape[1] * w[0, 0].numel()      # torch: out * kh * kw
    return w[0].numel()


@torch.no_grad()
def init_weights(model, generator):
    """Torch-default init of every Linear / Conv / ConvTranspose, sparse conv
    (a module with a `fan_in`) and BN of `model` from `generator` (a CPU
    torch.Generator), in module order.
    Values are drawn on the CPU and copied, so every device gets the same
    weights from the same seed."""
    for mod in model.modules():
        if (isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d))
                or hasattr(mod, 'fan_in')):
            bound = 1.0 / math.sqrt(_fan_in(mod))
            for p in (mod.weight, getattr(mod, 'bias', None)):
                if p is not None:
                    v = torch.rand(p.shape, generator=generator) * 2 - 1
                    p.copy_(v * bound)
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
