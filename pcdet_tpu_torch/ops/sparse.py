"""Batched sparse 3D convolution over rulebooks, and the rulebooks' device
builders.

Port of `pcdet_tpu.ops.sparse` with the batch written out (JAX vmaps per
sample).  A level keeps the JAX contracts: ids sorted ascending per sample
and INT_MAX padded, so live rows are a prefix; coords -1 on padding rows;
features zero on them (every conv multiplies its output by the mask).  The
rulebooks come from the host (`ops/host_books.py`, the default) or from
the builders here, on the level's own device (`subm_rules`,
`strided_out_set`, `inverse_rules_geometric`: `pcdet_tpu`'s
`_rules_subm` / `_rules_affine`, `_strided_out_set` and `_rules_inverse`),
through `host_books.build_books_device`.  Both give the same books, element
for element, in `host_books.decode_books`' layout: (B, V_out, K) int32
rules with misses at the input level's zero row V_in, taps in
`_kernel_offsets` order.  The device builders are sorts, binary searches
(`torch.searchsorted` on each sample's sorted ids, where the JAX package
merge-sorts to dodge the TPU's gathers), cumulative sums and scatters into
one spare slot: fixed shapes from static caps and no host sync.  An inverse
conv runs over the transpose of the book of the strided conv it inverts
(indice-key reuse) or, without that book, over `inverse_rules_geometric`.

Each conv is one launch of a gather-GEMM for the whole batch, through
`RulebookConv`, whose backward is two more launches: the feature gradient
is a gather-GEMM over the mirrored (subm) or transposed (strided)
rulebook, the weight gradient a dW kernel.  `Loads` chooses how a conv
whose kernel is 3 wide in x (`kw3`, every conv of BackBone8x but
conv_out) loads its rows, as the JAX package's four load switches do
(`PCDET_XWIN_FWD`, `PCDET_GATHER_SEG`, `PCDET_XWIN_DW`,
`PCDET_GATHER_SEG_DW`): `fwd` for the forward and the feature gradient,
`dw` for the weight gradient, each `rows` (kernels B / C and D: each row
of each tap), `xwin` (E and D″: a 3-row window per tap group) or `seg` (E′
and D′: a tile's span of windows per tap group).  The window kernels take
the book as x-window selectors (`xwin_selectors`), built once per book
and level.  On CPU tensors every kernel runs its plain version, so the CPU
tests hold the same formulas that the card runs.  Features stay f32
between layers; with compute_dtype bf16 a conv casts its input table to
bf16 once (JAX rounds inside the conv too).  `sparse_maxpool3d` is plain
torch, as `pcdet_tpu` leaves it to XLA.
"""
import math
from typing import Any, NamedTuple, Tuple

import torch

from .gather_dw import gather_dw, gather_dw_seg, gather_dw_xwin
from .gather_gemm import gather_gemm
# xwin_selectors and its inverse rules_from_xwin live beside kernels E / E′
from .gather_xwin import (gather_gemm_seg, gather_gemm_xwin, rules_from_xwin,
                          xwin_selectors)
from .host_books import INT_MAX

LOAD_CHOICES = ('rows', 'xwin', 'seg')


class Loads(NamedTuple):
    """How the kw=3 convs load rows: `fwd` for the forward and the feature
    gradient, `dw` for the weight gradient; each in `LOAD_CHOICES`."""
    fwd: str = 'rows'
    dw: str = 'rows'

    def check(self):
        for name, v in zip(self._fields, self):
            if v not in LOAD_CHOICES:
                raise ValueError('loads.%s must be one of %s, got %r'
                                 % (name, LOAD_CHOICES, v))
        return self


ROWS = Loads('rows', 'rows')
# The model's default (`models/backbones3d.BackBone8x`, the one layer that
# picks one), from chip_smoke.py's X4 on an H100 (PERF.md §6, "Load
# strategies"): in the forward E′ and B / C are equal kernels (one core,
# the same bits; E′'s sum over the 11 kw=3 convs is a little below C's), so
# the selector builds that window loads add to every batch decide it, and
# the forward stays `rows`; in the weight gradient D′ beats D and D″.
DEFAULT_LOADS = Loads('rows', 'seg')


def mirror_xwin(base, sel):
    """The selectors of the mirrored book `rules.flip(-1)` from those of
    `rules`: group g of the mirror is group G-1-g with its x-taps
    reversed, over the same window."""
    s = sel.flip(-1)
    return base.flip(-1), ((s & 3) << 4) | (s & 12) | ((s >> 4) & 3)


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


def _tap_offsets(kernel, device):
    """(K, 3) int64 tap offsets (dz, dy, dx), x fastest (the weight layout's
    and every book's tap order, `pcdet_tpu.ops.sparse._kernel_offsets`),
    made on `device`: no host to device copy, which would sync."""
    _, kh, kw = kernel
    t = torch.arange(math.prod(kernel), dtype=torch.int64, device=device)
    return torch.stack([t // (kh * kw), t // kw % kh, t % kw], -1)


def _lookup(ids, query, valid):
    """Rows of `query` ids in each sample's sorted `ids`.

    :param ids: (B, V) int32, ascending, INT_MAX padded
    :param query: (B, M) int64 ids; :param valid: (B, M) bool queries to find
    :return: rows (B, M) int64 clamped to [0, V - 1], found (B, M) bool
    """
    table = ids.to(torch.int64)
    rows = torch.searchsorted(table, query).clamp_(max=ids.shape[1] - 1)
    return rows, valid & (torch.gather(table, 1, rows) == query)


def _rules(rows, found, n_in, k):
    """(B, K * V) rows and found, tap-major -> (B, V, K) int32 rules with
    misses at `n_in`."""
    b = rows.shape[0]
    rules = torch.where(found, rows, n_in).to(torch.int32)
    return rules.reshape(b, k, -1).transpose(1, 2).contiguous()


def subm_rules(level, kernel=(3, 3, 3)):
    """Submanifold book of a level, built on its device: (B, V, K) int32,
    tap t of output row i the row of the live site at coords[i] + offs[t]
    - kernel // 2, else V (`pcdet_tpu.ops.sparse._rules_subm`, and
    `_rules_affine` for a kernel other than 1 or 3 wide).  The centre tap of
    an odd kernel is the identity on live rows.  Needs only `ids`,
    `coords`, `mask` and `shape` of the level."""
    kernel = _triple(kernel)
    b, v = level.ids.shape
    dev = level.ids.device
    eoffs = _tap_offsets(kernel, dev)[:, None, :]              # (K, 1, 3)
    c = level.coords.to(torch.int64)[:, None]                  # (B, 1, V, 3)
    ok = level.mask[:, None]
    for d in range(3):
        cd = c[..., d] + (eoffs[None, ..., d] - kernel[d] // 2)  # (B, K, V)
        ok = ok & (cd >= 0) & (cd < level.shape[d])
    _, h, w = level.shape
    lin = linearize(eoffs, level.shape) - (
        (kernel[0] // 2 * h + kernel[1] // 2) * w + kernel[2] // 2)  # (K, 1)
    query = linearize(c[:, 0], level.shape)[:, None] + lin[None]
    k = eoffs.shape[0]
    rows, found = _lookup(level.ids, query.reshape(b, -1), ok.reshape(b, -1))
    return _rules(rows, found, v, k)


def strided_out_set(level, kernel, stride, padding, out_cap):
    """Output set and forward book of a strided conv or pool, built on the
    level's device (`pcdet_tpu.ops.sparse._strided_out_set`): every output
    position whose receptive field touches a live input, the first
    `out_cap` of them in id order.  Each live input proposes its <=
    prod(ceil(k / s)) candidate outputs, carrying `tap * V + input row`;
    one sort of the candidates per sample and a run-length count give the
    output rows, and every kept candidate IS a book entry ((output, tap)
    pairs are unique), scattered into place.

    :return: ids (B, O) int32 ascending, INT_MAX padded; coords (B, O, 3)
        int32, -1 padded; mask (B, O) bool; dropped (B,) int32, the live
        outputs past the cap; rules (B, O, K) int32, misses at V
    """
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    b, v = level.ids.shape
    dev = level.ids.device
    big = int(INT_MAX)          # a Python int: no tensor to copy to `dev`
    out_shape = conv_out_shape(level.shape, kernel, stride, padding)
    _, kh, kw = kernel
    k = math.prod(kernel)
    # the candidates of every input at once, (B, C, V): candidate-major, as
    # the JAX package concatenates them
    cand = _tap_offsets(tuple(-(-kernel[d] // stride[d]) for d in range(3)),
                        dev)[:, None, :]                        # (C, 1, 3)
    c = level.coords.to(torch.int64)[:, None]                  # (B, 1, V, 3)
    ok = level.mask[:, None]
    o, t = [], []
    for d in range(3):
        cd = c[..., d]
        od = -((kernel[d] - 1 - padding[d] - cd) // stride[d]) + cand[..., d]
        ok = ok & (od <= (cd + padding[d]) // stride[d]) & (od >= 0) & (
            od < out_shape[d])
        o.append(od)
        t.append(cd + padding[d] - od * stride[d])    # in = out * s - p + t
    row = torch.arange(v, dtype=torch.int64, device=dev)
    cand_ids = torch.where(ok, (o[0] * out_shape[1] + o[1]) * out_shape[2]
                           + o[2], big).reshape(b, -1)
    cand_origin = (((t[0] * kh + t[1]) * kw + t[2]) * v + row).reshape(b, -1)
    keys, order = torch.sort(cand_ids, dim=1, stable=True)
    origin = torch.gather(cand_origin, 1, order)
    live = keys < big
    first = live.clone()
    first[:, 1:] &= keys[:, 1:] != keys[:, :-1]
    rank = torch.cumsum(first, 1) - 1                  # output row
    dropped = (first.sum(1) - out_cap).clamp_(min=0).to(torch.int32)
    slot = torch.where(first & (rank < out_cap), rank, out_cap)
    ids = torch.full((b, out_cap + 1), big, dtype=torch.int64, device=dev)
    ids = ids.scatter_(1, slot, keys)[:, :out_cap]
    mask = ids < big
    plane = out_shape[1] * out_shape[2]
    coords = torch.stack([ids // plane, ids // out_shape[2] % out_shape[1],
                          ids % out_shape[2]], -1)
    coords = torch.where(mask[..., None], coords, -1).to(torch.int32)
    slot = torch.where(live & (rank < out_cap), rank * k + origin // v,
                       out_cap * k)
    rules = torch.full((b, out_cap * k + 1), v, dtype=torch.int32, device=dev)
    rules = rules.scatter_(1, slot, (origin % v).to(torch.int32))
    return (ids.to(torch.int32).contiguous(), coords, mask, dropped,
            rules[:, :out_cap * k].reshape(b, out_cap, k).contiguous())


def inverse_rules_geometric(level, target, kernel, stride, padding):
    """Book of the inverse conv of `level` (coarse) onto the sites of
    `target` (fine) from the geometry alone, built on the device
    (`pcdet_tpu.ops.sparse._rules_inverse`): tap t of fine row u reads the
    live coarse site (u + padding - t) / stride, where that divides.
    Equal to `inverse_rules` of the strided conv's book that made `level`
    from `target`, which the JAX package's key reuse gives.

    :return: (B, V_fine, K) int32 rules, misses at V_coarse
    """
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    b, n_coarse = level.ids.shape
    offs = _tap_offsets(kernel, level.ids.device)[:, None, :]   # (K, 1, 3)
    u = target.coords.to(torch.int64)[:, None]                # (B, 1, Vf, 3)
    ok = target.mask[:, None]
    q = []
    for d in range(3):
        num = u[..., d] + padding[d] - offs[None, ..., d]      # (B, K, Vf)
        qd = num // stride[d]
        ok = ok & (num >= 0) & (num % stride[d] == 0) & (qd < level.shape[d])
        q.append(qd)
    query = linearize(torch.stack(q, -1), level.shape)
    rows, found = _lookup(level.ids, query.reshape(b, -1), ok.reshape(b, -1))
    return _rules(rows, found, n_coarse, offs.shape[0])


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


def _gemm(loads_fwd, table, rules, xwin, weights, n_live, dgrad=False):
    """One gather-GEMM by the chosen loads (`xwin` None: rows)."""
    if xwin is None or loads_fwd == 'rows':
        return gather_gemm(table, rules, weights, n_live, dgrad=dgrad)
    fn = gather_gemm_xwin if loads_fwd == 'xwin' else gather_gemm_seg
    return fn(table, *xwin, weights, n_live, dgrad=dgrad)


class RulebookConv(torch.autograd.Function):
    """out = gather-GEMM(table, rules, W, n_live_out), differentiated by
    gather-GEMMs and a dW kernel (`_gm_subm_bwd` and
    `_apply_rules_transpose_bwd` of `pcdet_tpu`):

        d table = gather-GEMM(g ‖ 0, bwd_rules, W^T, n_live_in)
        dW      = dW kernel(table, rules, g, n_live_out)

    `bwd_rules` is the mirrored book `rules.flip(-1)` for a subm conv (its
    tap-reversed book is its own transpose; outputs are its inputs, so
    n_live_in == n_live_out) and `transpose_rules(rules, ...)` for a
    strided one; None builds it in the backward.  `xwin` / `bwd_xwin` are
    the books' (base, sel) selectors for a kw=3 conv, None for rows loads
    (or, for `bwd_xwin`, built in the backward); `loads.fwd` picks the
    forward's and the feature gradient's kernel, `loads.dw` the weight
    gradient's.  The feature gradient is skipped when the table needs none
    (the input level's MeanVFE features have no parameters behind them).
    """

    @staticmethod
    def forward(ctx, table, weights, rules, n_live_out, n_live_in,
                bwd_rules, subm, loads, xwin, bwd_xwin):
        base, sel = xwin if xwin is not None else (None, None)
        bb, bs = bwd_xwin if bwd_xwin is not None else (None, None)
        ctx.save_for_backward(table, weights, rules, n_live_out, n_live_in,
                              bwd_rules, base, sel, bb, bs)
        ctx.subm, ctx.loads = subm, loads
        return _gemm(loads.fwd, table, rules, xwin, weights, n_live_out)

    @staticmethod
    def backward(ctx, g):
        (table, weights, rules, n_live_out, n_live_in, bwd_rules, base, sel,
         bb, bs) = ctx.saved_tensors
        loads = ctx.loads
        kw3 = base is not None
        g = g.contiguous()
        d_table = d_w = None
        if ctx.needs_input_grad[0]:
            b, v_in1, cin = table.shape
            n_in, n_out = v_in1 - 1, rules.shape[1]
            bwd_xwin = (bb, bs) if bb is not None else None
            if kw3 and loads.fwd != 'rows' and bwd_xwin is None:
                bwd_xwin = (mirror_xwin(base, sel) if ctx.subm else
                            xwin_selectors(transpose_rules(rules, n_in, n_out),
                                           n_out)[:2])
            if bwd_rules is None and (not kw3 or loads.fwd == 'rows'):
                bwd_rules = (rules.flip(-1) if ctx.subm else
                             transpose_rules(rules, n_in, n_out))
            g_table = torch.cat([g.to(table.dtype),
                                 g.new_zeros((b, 1, g.shape[2]),
                                             dtype=table.dtype)], dim=1)
            w_t = weights.transpose(1, 2).to(table.dtype).contiguous()
            df = _gemm(loads.fwd, g_table, bwd_rules,
                       bwd_xwin if kw3 else None, w_t, n_live_in, dgrad=True)
            d_table = torch.cat([df.to(table.dtype),
                                 df.new_zeros((b, 1, cin), dtype=table.dtype)],
                                dim=1)
        if ctx.needs_input_grad[1]:
            if kw3 and loads.dw != 'rows':
                fn = gather_dw_xwin if loads.dw == 'xwin' else gather_dw_seg
                d_w = fn(table, base, sel, g, n_live_out)
            else:
                d_w = gather_dw(table, rules, g, n_live_out)
            d_w = d_w.to(weights.dtype)
        return d_table, d_w, None, None, None, None, None, None, None, None


def _apply_rules(level, out_mask, rules, weights, compute_dtype, subm, loads,
                 kw3, bwd_rules=None, xwin=None, bwd_xwin=None):
    """out = sum_k feats[rules[.., k]] @ W[k], masked; (B, V_out, Cout) f32.

    The input table gets its zero row (index V_in, where the books route
    misses) and, for bf16, is cast once here.  A kw=3 conv whose loads are
    not all `rows` builds its selectors here unless the caller shares
    them (the weight gradient's only when one will be taken)."""
    features = level.features
    b, v_in, cin = features.shape
    dtype = compute_dtype or features.dtype
    table = torch.cat([features.to(dtype),
                       features.new_zeros((b, 1, cin), dtype=dtype)], dim=1)
    n_live = out_mask.sum(dim=1, dtype=torch.int32)
    n_live_in = n_live if subm else level.mask.sum(dim=1, dtype=torch.int32)
    loads = Loads(*loads).check()
    dw_window = (loads.dw != 'rows' and torch.is_grad_enabled()
                 and weights.requires_grad)
    if not kw3 or (loads.fwd == 'rows' and not dw_window):
        xwin = bwd_xwin = None
    elif xwin is None:
        xwin = xwin_selectors(rules, v_in)[:2]
    out = RulebookConv.apply(table, weights.to(dtype).contiguous(), rules,
                             n_live, n_live_in, bwd_rules, subm, loads, xwin,
                             bwd_xwin)
    return out * out_mask[..., None].to(out.dtype)


def subm_conv3d(level, weights, rules, compute_dtype=None, mirror=None, *,
                loads, kw3, xwin=None, mirror_xwin=None):
    """Submanifold conv: output sites == input sites.

    :param weights: (K, Cin, Cout) f32; :param rules: (B, V, K) int32 book
    :param mirror: `rules.flip(-1)` when the caller shares it between the
        convs of a level (training); None flips in the backward
    :param loads: `Loads` (the model's choice; no default here); `kw3`:
        the kernel is 3 wide in x, so `loads` apply
    :param xwin, mirror_xwin: the selectors of `rules` and of the mirror
        when the caller shares them; None builds them where needed
    """
    feats = _apply_rules(level, level.mask, rules, weights, compute_dtype,
                         True, loads, kw3, mirror, xwin, mirror_xwin)
    return level._replace(features=feats, overflow=None)


def sparse_conv3d(level, weights, book, kernel, stride, padding,
                  compute_dtype=None, *, loads, xwin=None, bwd_xwin=None):
    """Strided sparse conv: output sites = every position whose receptive
    field touches an active input, as the host book lists them.

    :param book: (out_ids, out_coords, out_mask, dropped, rules) from
        `ops.host_books.upload_books`
    :param loads: `Loads` (the model's choice; no default here), for a
        kernel 3 wide in x
    :param xwin, bwd_xwin: the selectors of the rules and of the
        transposed book when the caller built them; None builds them where
        needed
    """
    out_ids, out_coords, out_mask, dropped, rules = book
    feats = _apply_rules(level, out_mask, rules, weights, compute_dtype,
                         False, loads, _triple(kernel)[2] == 3, None, xwin,
                         bwd_xwin)
    return SparseLevel(feats, out_ids, out_coords, out_mask,
                       conv_out_shape(level.shape, kernel, stride, padding),
                       overflow=dropped)


def inverse_rules(rules, fine_mask):
    """The book of the inverse of a strided conv: its forward `rules` (B,
    V_coarse, K) transposed (`transpose_rules`) onto the fine level's live
    sites, (B, V_fine, K) with misses at V_coarse."""
    n_fine, n_coarse = fine_mask.shape[1], rules.shape[1]
    return torch.where(fine_mask[..., None],
                       transpose_rules(rules, n_fine, n_coarse), n_coarse)


def inverse_conv3d(level, target, weights, book, kernel, stride, padding,
                   compute_dtype=None, *, loads, rules_t=None, xwin=None,
                   bwd_xwin=None):
    """Inverse (up) conv of a coarse level onto the sites of `target`, the
    fine level whose strided conv produced it: spconv's SparseInverseConv3d
    (`pcdet_tpu.ops.sparse.inverse_conv3d`).  On indice-key reuse its book
    is the transpose of that conv's forward book, so tap t meets weight tap
    t as in the JAX package; where `book` is None or is not the book that
    made `level` (its rules' shape or output ids differ), the book comes
    from the geometry (`inverse_rules_geometric`, the same rules), as
    `pcdet_tpu` falls back to `_rules_inverse`.

    :param level: the coarse input level (the strided conv's output sites)
    :param target: the fine level; its ids, coords and mask are the output's
    :param book: the strided conv's (out_ids, out_coords, out_mask,
        dropped, rules) from `ops.host_books.upload_books` or
        `build_books_device`, or None
    :param kernel, stride, padding: the strided conv's
    :param loads: `Loads` (no default here), for a kernel 3 wide in x
    :param rules_t: `inverse_rules` of the book when the caller built it;
        None builds it here
    :param xwin: its selectors when the caller built them
    :param bwd_xwin: the selectors of the book's rules when the caller
        built them (the strided conv's own; None builds them where needed)

    On reuse the feature gradient runs over the transpose of `rules_t`,
    which is the strided conv's forward book on the fine level's live
    sites: the book's rules as they are, which the backward takes (and
    `bwd_xwin`) instead of rebuilding them by a scatter.  On the geometric
    book the backward transposes `rules_t`, which gives the same rules.
    :raises ValueError: where the geometry does not give `level`'s shape
        from `target`'s
    """
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    b, n_coarse = level.ids.shape
    n_fine = target.ids.shape[1]
    if conv_out_shape(target.shape, kernel, stride, padding) != level.shape:
        raise ValueError('a conv %s / %s / %s of %s gives %s, not the input '
                         'level\'s %s' % (kernel, stride, padding,
                                          target.shape, conv_out_shape(
                                              target.shape, kernel, stride,
                                              padding), level.shape))
    rules = None if book is None else book[4]
    if (rules is None
            or tuple(rules.shape) != (b, n_coarse, math.prod(kernel))
            or (book[0] is not level.ids
                and not torch.equal(book[0], level.ids))):
        rules = xwin = bwd_xwin = None
        rules_t = inverse_rules_geometric(level, target, kernel, stride,
                                          padding)
    elif rules_t is None:
        rules_t = inverse_rules(rules, target.mask)
    if tuple(rules_t.shape) != (b, n_fine, math.prod(kernel)):
        raise ValueError('rules_t %s: want (B, V_fine, K) = %s' % (
            tuple(rules_t.shape), (b, n_fine, math.prod(kernel))))
    feats = _apply_rules(level, target.mask, rules_t, weights, compute_dtype,
                         False, loads, kernel[2] == 3, rules, xwin, bwd_xwin)
    return target._replace(features=feats, overflow=None)


def sparse_maxpool3d(level, kernel=3, stride=2, padding=1, out_cap=None):
    """Sparse max-pool (spconv SparseMaxPool3d, `pcdet_tpu.ops.sparse.
    sparse_maxpool3d`): each output, the output set of a strided conv of
    the same geometry (`strided_out_set`, at `out_cap`, the input cap when
    None), takes the per-channel max over the live inputs of its taps; 0
    on padding rows.  Plain torch: the JAX package leaves it to XLA.

    :return: SparseLevel at the output shape, `overflow` the dropped
        outputs (B,) int32
    """
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    ids, coords, mask, dropped, rules = strided_out_set(
        level, kernel, stride, padding, out_cap or level.ids.shape[1])
    f = level.features
    b, _, c = f.shape
    neg = torch.finfo(f.dtype).min
    table = torch.cat([f, f.new_full((b, 1, c), neg)], 1)
    acc = table.new_full((b, rules.shape[1], c), neg)
    for t in range(rules.shape[2]):
        idx = rules[..., t].to(torch.int64)[..., None].expand(-1, -1, c)
        acc = torch.maximum(acc, torch.gather(table, 1, idx))
    feats = torch.where(mask[..., None] & (acc > neg / 2), acc, 0.0)
    return SparseLevel(feats, ids, coords, mask,
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
