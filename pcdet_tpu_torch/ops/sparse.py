"""Batched sparse 3D convolution over host-built rulebooks.

Port of the eval forward of `pcdet_tpu.ops.sparse` with the batch written
out (JAX vmaps per sample).  A level keeps the JAX contracts: ids sorted
ascending per sample and INT_MAX padded, so live rows are a prefix; coords
-1 on padding rows; features zero on them (every conv multiplies its output
by the mask).  The rulebooks come from `ops/host_books.py` (the CLI
default in `pcdet_tpu`); the device builders of `pcdet_tpu.ops.sparse`
(`_rules_subm`, `_strided_out_set`) are not ported yet.

Each conv is one launch of the gather-GEMM (`ops/gather_gemm.py`) for the
whole batch.  Features stay f32 between layers; with compute_dtype bf16 a
conv casts its input table to bf16 once (JAX rounds inside the conv too).
"""
from typing import Any, NamedTuple, Tuple

import torch

from pcdet_tpu.ops.host_books import INT_MAX

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


def _apply_rules(features, out_mask, rules, weights, compute_dtype):
    """out = sum_k feats[rules[.., k]] @ W[k], masked; (B, V_out, Cout) f32.

    The input table gets its zero row (index V_in, where the books route
    misses) and, for bf16, is cast once here."""
    b, v_in, cin = features.shape
    dtype = compute_dtype or torch.float32
    table = features.new_empty((b, v_in + 1, cin), dtype=dtype)
    table[:, :v_in] = features
    table[:, v_in] = 0
    n_live = out_mask.sum(dim=1, dtype=torch.int32)
    out = gather_gemm(table, rules, weights.to(dtype).contiguous(), n_live)
    return out * out_mask[..., None].to(out.dtype)


def subm_conv3d(level, weights, rules, compute_dtype=None):
    """Submanifold conv: output sites == input sites.

    :param weights: (K, Cin, Cout) f32; :param rules: (B, V, K) int32 book
    """
    feats = _apply_rules(level.features, level.mask, rules, weights,
                         compute_dtype)
    return level._replace(features=feats, overflow=None)


def sparse_conv3d(level, weights, book, kernel, stride, padding,
                  compute_dtype=None):
    """Strided sparse conv: output sites = every position whose receptive
    field touches an active input, as the host book lists them.

    :param book: (out_ids, out_coords, out_mask, dropped, rules) from
        `ops.host_books.upload_books`
    """
    out_ids, out_coords, out_mask, dropped, rules = book
    feats = _apply_rules(level.features, out_mask, rules, weights,
                         compute_dtype)
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
