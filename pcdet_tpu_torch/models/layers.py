"""Building blocks with the reference's parameter names and BN semantics.

Twins of `pcdet_tpu.models.layers`: BatchNorm with eps 1e-3 and momentum
0.01 normalises by its running statistics in eval and by the batch's in
training (`TorchBatchNorm`, one BN group), optionally over the rows a mask
keeps.

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


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (channels-last) or axis 1 (NCHW).

    Training (`pcdet_tpu.models.layers.TorchBatchNorm`, BN_GROUPS 1):
    normalise by the batch mean and biased variance over every axis but the
    channel's, or over the rows `mask` keeps (a (B, V) mask of a
    channels-last (B, V, C) input: the live voxels of the whole batch); the
    running statistics take momentum 0.01 of the mean and of the unbiased
    variance var * n / (n - 1).  Written out by hand: F.batch_norm takes no
    mask.  `mask` is ignored in eval.
    """

    def __init__(self, features, eps=1e-3, momentum=0.01, channel_dim=-1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.channel_dim = channel_dim
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
        dims = [d for d in range(x.dim()) if d != self.channel_dim % x.dim()]
        if mask is None:
            n = torch.tensor(float(x.numel() // x.shape[self.channel_dim]),
                             dtype=x.dtype, device=x.device)
            mean = x.mean(dim=dims)
            var = torch.square(x - mean.view(shape)).mean(dim=dims)
        else:
            w = mask.to(x.dtype)[..., None]
            n = torch.clamp(w.sum(), min=1.0)
            mean = (x * w).sum(dim=dims) / n
            var = (torch.square(x - mean.view(shape)) * w).sum(dim=dims) / n
        with torch.no_grad():
            m = self.momentum
            unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
            self.num_batches_tracked += 1
        y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return y * self.weight.view(shape) + self.bias.view(shape)


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
