"""Batched sparse 3D convolution over host-built rulebooks.

Port of `pcdet_tpu.ops.sparse`'s book-driven convs with the batch written
out (JAX vmaps per sample).  A level keeps the JAX contracts: ids sorted
ascending per sample and INT_MAX padded, so live rows are a prefix; coords
-1 on padding rows; features zero on them (every conv multiplies its output
by the mask).  The rulebooks come from `ops/host_books.py` (the CLI
default in `pcdet_tpu`); the device builders of `pcdet_tpu.ops.sparse`
(`_rules_subm`, `_strided_out_set`) are not ported yet.

Each conv is one launch of the gather-GEMM (`ops/gather_gemm.py`) for the
whole batch, through `RulebookConv`, whose backward is two more kernel
launches: the feature gradient is the gather-GEMM over the mirrored
(subm) or transposed (strided) rulebook, the weight gradient is kernel D
(`ops/gather_dw.py`).  On CPU tensors both run their plain versions, so the
CPU tests hold the same backward formulas that the card runs.  Features
stay f32 between layers; with compute_dtype bf16 a conv casts its input
table to bf16 once (JAX rounds inside the conv too).
"""
from typing import Any, NamedTuple, Tuple

import torch

from pcdet_tpu.ops.host_books import INT_MAX

from .gather_dw import gather_dw
from .gather_gemm import gather_gemm


class SparseLevel(NamedTuple):
    """One resolution level of a batch of sparse tensors."""
    features: torch.Tensor     # (B, V, C) f32, zero on padding rows
    ids: torch.Tensor          # (B, V) int32, sorted ascending, INT_MAX pad
    coords: torch.Tensor       # (B, V, 3) int32 ZYX, -1 pad
    mask: torch.Tensor         # (B, V) bool, a prefix per sample
    shape: Tuple[int, int, int]   # (D, H, W)
    # active sites the producing strided conv's cap dropped, (B,) int32;
    # None where the producing op has no cap
    overflow: Any = None


def _triple(x):
    if isinstance(x, (tuple, list)):
        return tuple(int(v) for v in x)
    return (int(x),) * 3


def linearize(coords, shape):
    """(.., 3) ZYX -> linear id over (D, H, W)."""
    _, h, w = shape
    return (coords[..., 0] * h + coords[..., 1]) * w + coords[..., 2]


def from_voxelizer(features, coords, voxel_mask, shape):
    """A level from the voxelizer's outputs (sorted by linear id).  `shape`
    is the SPARSE shape (grid z + 1, y, x): ids linearised over the grid
    sort the same but do not match the books."""
    ids = torch.where(voxel_mask, linearize(coords, shape), INT_MAX)
    return SparseLevel(features, ids.to(torch.int32), coords, voxel_mask,
                       tuple(shape))


def conv_out_shape(in_shape, kernel, stride, padding):
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    return tuple((in_shape[i] + 2 * padding[i] - kernel[i]) // stride[i] + 1
                 for i in range(3))


def transpose_rules(rules, n_in, n_out):
    """Invert a batch of forward rulebooks into the transpose books by one
    scatter (`pcdet_tpu.ops.sparse._transpose_rules_from_fwd`, batched).

    For a fixed (input row, tap) the contributing output row is unique in
    every strided geometry, so the forward entry (out o, tap t) -> input u
    IS the transpose entry (input u, tap t) -> o: scattering o * 2 + 1 into
    slot u * K + t never collides; misses go to one drop slot.

    :param rules: (B, n_out, K) int32 forward rules, misses at n_in
    :return: (B, n_in, K) int32 transpose rules, misses at n_out
    """
    b, v, k = rules.shape
    found = rules != n_in
    tap = torch.arange(k, dtype=torch.int32, device=rules.device)
    slot = torch.where(found, rules * k + tap, n_in * k).long()
    o = torch.arange(v, dtype=torch.int32, device=rules.device)
    packed = rules.new_zeros((b, n_in * k + 1))
    packed.scatter_(1, slot.reshape(b, -1),
                    (o * 2 + 1)[None, :, None].expand(b, v, k).reshape(b, -1))
    packed = packed[:, :n_in * k].reshape(b, n_in, k)
    return torch.where((packed & 1) > 0, packed >> 1, n_out)


class RulebookConv(torch.autograd.Function):
    """out = gather_gemm(table, rules, W, n_live_out), differentiated by
    gather-GEMMs and kernel D (`_gm_subm_bwd` and
    `_apply_rules_transpose_bwd` of `pcdet_tpu`):

        d table = gather_gemm(g ‖ 0, bwd_rules, W^T, n_live_in)
        dW      = gather_dw(table, rules, g, n_live_out)

    `bwd_rules` is the mirrored book `rules.flip(-1)` for a subm conv (its
    tap-reversed book is its own transpose; outputs are its inputs, so
    n_live_in == n_live_out) and `transpose_rules(rules, ...)` for a
    strided one; None builds it in the backward.  The feature gradient is
    skipped when the table needs none (the input level's MeanVFE features
    have no parameters behind them).
    """

    @staticmethod
    def forward(ctx, table, weights, rules, n_live_out, n_live_in,
                bwd_rules, subm):
        ctx.save_for_backward(table, weights, rules, n_live_out, n_live_in,
                              bwd_rules)
        ctx.subm = subm
        return gather_gemm(table, rules, weights, n_live_out)

    @staticmethod
    def backward(ctx, g):
        table, weights, rules, n_live_out, n_live_in, bwd_rules = \
            ctx.saved_tensors
        g = g.contiguous()
        d_table = d_w = None
        if ctx.needs_input_grad[0]:
            b, v_in1, cin = table.shape
            n_in = v_in1 - 1
            if bwd_rules is None:
                bwd_rules = (rules.flip(-1) if ctx.subm else
                             transpose_rules(rules, n_in, rules.shape[1]))
            g_table = torch.cat([g.to(table.dtype),
                                 g.new_zeros((b, 1, g.shape[2]),
                                             dtype=table.dtype)], dim=1)
            w_t = weights.transpose(1, 2).to(table.dtype).contiguous()
            df = gather_gemm(g_table, bwd_rules, w_t, n_live_in, dgrad=True)
            d_table = torch.cat([df.to(table.dtype),
                                 df.new_zeros((b, 1, cin), dtype=table.dtype)],
                                dim=1)
        if ctx.needs_input_grad[1]:
            d_w = gather_dw(table, rules, g, n_live_out).to(weights.dtype)
        return d_table, d_w, None, None, None, None, None


def _apply_rules(level, out_mask, rules, weights, compute_dtype, subm,
                 bwd_rules=None):
    """out = sum_k feats[rules[.., k]] @ W[k], masked; (B, V_out, Cout) f32.

    The input table gets its zero row (index V_in, where the books route
    misses) and, for bf16, is cast once here."""
    features = level.features
    b, _, cin = features.shape
    dtype = compute_dtype or features.dtype
    table = torch.cat([features.to(dtype),
                       features.new_zeros((b, 1, cin), dtype=dtype)], dim=1)
    n_live = out_mask.sum(dim=1, dtype=torch.int32)
    n_live_in = n_live if subm else level.mask.sum(dim=1, dtype=torch.int32)
    out = RulebookConv.apply(table, weights.to(dtype).contiguous(), rules,
                             n_live, n_live_in, bwd_rules, subm)
    return out * out_mask[..., None].to(out.dtype)


def subm_conv3d(level, weights, rules, compute_dtype=None, mirror=None):
    """Submanifold conv: output sites == input sites.

    :param weights: (K, Cin, Cout) f32; :param rules: (B, V, K) int32 book
    :param mirror: `rules.flip(-1)` when the caller shares it between the
        convs of a level (training); None flips in the backward
    """
    feats = _apply_rules(level, level.mask, rules, weights, compute_dtype,
                         True, mirror)
    return level._replace(features=feats, overflow=None)


def sparse_conv3d(level, weights, book, kernel, stride, padding,
                  compute_dtype=None):
    """Strided sparse conv: output sites = every position whose receptive
    field touches an active input, as the host book lists them.

    :param book: (out_ids, out_coords, out_mask, dropped, rules) from
        `ops.host_books.upload_books`
    """
    out_ids, out_coords, out_mask, dropped, rules = book
    feats = _apply_rules(level, out_mask, rules, weights, compute_dtype,
                         False)
    return SparseLevel(feats, out_ids, out_coords, out_mask,
                       conv_out_shape(level.shape, kernel, stride, padding),
                       overflow=dropped)


def to_dense(level):
    """(B, V, C) sparse -> (B, D, H, W, C) dense by one scatter."""
    d, h, w = level.shape
    b, _, c = level.features.shape
    n = d * h * w
    flat = torch.where(level.mask, level.ids, n).long()
    canvas = level.features.new_zeros((b, n + 1, c))
    canvas.scatter_(1, flat[..., None].expand(-1, -1, c), level.features)
    return canvas[:, :n].reshape(b, d, h, w, c)
