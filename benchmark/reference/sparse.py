"""Plain sparse 3D convolution over coordinate lookups.

A level holds the active sites of a batch as rows: coords (N, 4) int64 [b,
z, y, x], sorted by scan and then by linear id, and features (N, C).  A
submanifold conv keeps the sites; tap t of output site o reads the site o +
offset_t - kernel // 2.  A strided conv's output sites are every position
whose receptive field holds an active input, the lowest `cap` linear ids
of each scan kept; tap t of output o reads the input at o * stride -
padding + offset_t.  Weights are (kz, ky, kx, Cin, Cout), taps in z, y, x
order with x fastest.  Each conv can also report the work it needs (found
taps, distinct rows read), which the benchmark's roofline and MFU count.
"""
from dataclasses import dataclass

import torch


@dataclass
class Level:
    coords: torch.Tensor      # (N, 4) int64 [b, z, y, x]
    feats: torch.Tensor       # (N, C)
    shape: tuple              # (D, H, W)
    batch: int


def keys(coords, shape):
    d, h, w = shape
    return ((coords[:, 0] * d + coords[:, 1]) * h + coords[:, 2]) * w \
        + coords[:, 3]


def taps(kernel, device):
    kz, ky, kx = kernel
    t = torch.arange(kz * ky * kx, device=device)
    return torch.stack([t // (ky * kx), t // kx % ky, t % kx], 1)


def lookup(level, query, valid):
    """Rows of `query` coords (M, 4) in `level`, and whether found."""
    table = keys(level.coords, level.shape)
    q = keys(torch.where(valid[:, None], query, 0), level.shape)
    idx = torch.searchsorted(table, q).clamp_(max=max(len(table) - 1, 0))
    found = valid & (table[idx] == q) if len(table) else valid & False
    return idx, found


def out_shape(shape, kernel, stride, padding):
    return tuple((shape[i] + 2 * padding[i] - kernel[i]) // stride[i] + 1
                 for i in range(3))


def _gather_conv(level, weight, rows, found, quant):
    """sum_t feats[rows[t]] @ W[t] over found taps: (M, Cout)."""
    k = weight.shape[0] * weight.shape[1] * weight.shape[2]
    w = quant(weight.reshape(k, weight.shape[3], weight.shape[4]))
    x = quant(level.feats)
    g = x[rows] * found[..., None].to(x.dtype)           # (K, M, Cin)
    return torch.bmm(g, w).sum(0)


def _work(work, name, found, rows, cin, cout, k, n_in):
    """Per-conv counts: found (live output, tap) pairs, distinct input rows
    read, live outputs, live inputs, and the distinct output rows that the
    feature gradient reads (outputs with a found tap)."""
    if work is None:
        return
    read = torch.unique(rows[found]).numel()
    work.append({'name': name, 'k': k, 'cin': cin, 'cout': cout,
                 'found': int(found.sum()), 'rows_read': int(read),
                 'n_out': int(found.shape[1]), 'n_in': int(n_in),
                 'out_read': int(found.any(0).sum())})


def subm_conv(level, weight, quant, work=None, name=''):
    kernel = tuple(weight.shape[:3])
    offs = taps(kernel, level.coords.device) - torch.tensor(
        [k // 2 for k in kernel], device=level.coords.device)
    q = level.coords[None].clone().repeat(len(offs), 1, 1)
    q[..., 1:] += offs[:, None]
    valid = ((q[..., 1:] >= 0)
             & (q[..., 1:] < torch.tensor(level.shape,
                                          device=q.device))).all(-1)
    idx, found = lookup(level, q.reshape(-1, 4), valid.reshape(-1))
    idx, found = idx.view(valid.shape), found.view(valid.shape)
    _work(work, name, found, idx, weight.shape[3], weight.shape[4],
          len(offs), len(level.coords))
    return Level(level.coords, _gather_conv(level, weight, idx, found, quant),
                 level.shape, level.batch)


def strided_sites(level, kernel, stride, padding, cap):
    """Output coords (M, 4) of a strided conv and the live sites each scan
    lost to `cap`."""
    dev = level.coords.device
    oshape = out_shape(level.shape, kernel, stride, padding)
    offs = taps(kernel, dev)
    num = (level.coords[None, :, 1:] + torch.tensor(padding, device=dev)
           - offs[:, None])                                    # (K, N, 3)
    s = torch.tensor(stride, device=dev)
    o = torch.div(num, s, rounding_mode='floor')
    ok = ((num >= 0) & (num % s == 0)
          & (o < torch.tensor(oshape, device=dev))).all(-1)
    b = level.coords[None, :, :1].expand(len(offs), -1, 1)
    cand = torch.cat([b, o], -1)[ok]
    uniq = torch.unique(keys(cand, oshape))                    # sorted
    d, h, w = oshape
    per = d * h * w
    sample = uniq // per
    first = torch.searchsorted(uniq, sample * per)
    rank = torch.arange(len(uniq), device=dev) - first
    counts = torch.bincount(sample, minlength=level.batch)
    dropped = torch.clamp(counts - cap, min=0).tolist()
    kept = uniq[rank < cap]
    lin = kept % per
    coords = torch.stack([kept // per, lin // (h * w), lin // w % h, lin % w],
                         1)
    return coords, oshape, dropped


def strided_conv(level, weight, stride, padding, cap, quant, work=None,
                 name=''):
    kernel = tuple(weight.shape[:3])
    coords, oshape, dropped = strided_sites(level, kernel, stride, padding,
                                            cap)
    dev = coords.device
    offs = taps(kernel, dev)
    q = coords[None].clone().repeat(len(offs), 1, 1)
    q[..., 1:] = (q[..., 1:] * torch.tensor(stride, device=dev)
                  - torch.tensor(padding, device=dev) + offs[:, None])
    valid = ((q[..., 1:] >= 0)
             & (q[..., 1:] < torch.tensor(level.shape, device=dev))).all(-1)
    idx, found = lookup(level, q.reshape(-1, 4), valid.reshape(-1))
    idx, found = idx.view(valid.shape), found.view(valid.shape)
    _work(work, name, found, idx, weight.shape[3], weight.shape[4],
          len(offs), len(level.coords))
    out = Level(coords, _gather_conv(level, weight, idx, found, quant),
                oshape, level.batch)
    return out, dropped


def to_bev(level):
    """(B, C * D, H, W) with channel c * D + d, zero where no site is."""
    d, h, w = level.shape
    c = level.feats.shape[1]
    dense = level.feats.new_zeros((level.batch, d, h, w, c))
    b, z, y, x = level.coords.unbind(1)
    dense = dense.index_put((b, z, y, x), level.feats)
    return dense.permute(0, 4, 1, 2, 3).reshape(level.batch, c * d, h, w)
