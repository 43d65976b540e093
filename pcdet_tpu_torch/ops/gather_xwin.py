"""Gather-GEMM of kw=3 books by x-window and segment loads (kernels E, E′).

A kw=3 book's taps come in groups of three x-taps, 3g, 3g+1, 3g+2, of one
(dz, dy) (the books' tap order has x fastest, `host_books._kernel_offsets`).
The three query the ids q-1, q, q+1, and present ids occupy consecutive
rows of the sorted table, so every found row of a group lies in a window of
three rows.  `xwin_selectors` writes a book as (base, sel): the window's
first row and, in bits 2dx..2dx+1, the window row of x-tap dx (3: a miss;
0x3f: no tap of the group found).  `rules_from_xwin` is its inverse.

`gather_gemm_xwin` (E) replaces `pcdet_tpu.ops.pallas.gather_gemm.
_gather_matmul_xwin_call` and `gather_gemm_seg` (E′) its
`_gather_matmul_seg_call`; both compute `ops/gather_gemm.gather_gemm`'s
function (kernels B and C) over (base, sel), with its contracts: the batch,
the zero row at V_in, `n_live` row gating, f32 output, an f32 and a bf16
instance by the dtype of `feats`.  E stages each row's window; E′ stages
the whole span of a 64-row tile's windows once when it is at most `s` rows
(`segment_desc` gives the descriptors `pcdet_tpu`'s `segment_desc` gives),
and E's windows where it is not.  On a CUDA tensor each launches the
hand-written kernel `csrc/gather_gemm_xwin.cu` (nvcc at first use) or
raises; on a CPU tensor it computes its plain version, which rebuilds the
rules from the selectors (and, for E′, from the segment descriptors) and
calls `gather_gemm_plain`, so it checks the descriptors as well as the sums.

On the card E and E′ share one pipelined core: f32 gives kernel B's bits
and bf16 kernel C's on the same book, so the load strategy changes no
output.  E′ stages a tile's segment in shared memory, so an instance takes
at most `max_seg_rows(dtype, Cin, Cout)` segment rows there (at least
`SEG_S`); the plain version takes 1..1022.

`LAUNCHES` counts launches per variant and dtype (`_dgrad` for a feature
gradient) and of the selector builder, `PAIR_LAUNCHES` per variant, dtype
and (Cin, Cout); `seg_tiles()` reads the (tile, group)s the segment kernels (E′
and D′) took by the segment branch and by the window branch, counted on the
card since `reset_seg_tiles()`.
"""
import ctypes
import functools

import torch

from . import cuda_build
from .gather_gemm import _MAX_GRID_Y, gather_gemm_plain

LAUNCHES = {'%s_%s%s' % (v, t, d): 0 for v in ('gather_gemm_xwin',
                                             'gather_gemm_seg')
            for t in ('f32', 'bf16') for d in ('', '_dgrad')}
LAUNCHES['xwin_selectors'] = 0
# launches of E and E′ by (variant and dtype as LAUNCHES names them, Cin, Cout)
PAIR_LAUNCHES = {}
# (Cin, Cout) of the instances: BackBone8x's kw=3 convs and the feature
# gradients over their transposed books (conv_input's is never taken), and
# UNetV2's decoder: its merge convs over 128 channels (up4_m, up3_m), their
# feature gradient (64 -> 128) and its inverse convs (64 -> 64, 64 -> 32,
# 32 -> 16)
PAIRS = ((4, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
         (32, 16), (64, 32), (128, 64), (64, 128))
TILE = 64              # rows per block, the tile of the segment descriptors
SEG_S = 256            # segment rows
MAX_GROUPS = 21
NO_TAP = 0x3f
SEG_MISS = 1023        # 10-bit offset of a miss
_SOURCES = ('gather_gemm_xwin.cu',)
SMEM_LIMIT = 232448    # a block's shared memory on sm_90
_TALLY = {}            # device -> (2,) int64: segment, window (tile, group)s


def xwin_selectors_plain(rules, n_in):
    """`xwin_selectors`' plain version (PyTorch ops)."""
    b, v, k = rules.shape
    r3 = rules.reshape(b, v, k // 3, 3)
    found = r3 != n_in
    big = torch.iinfo(torch.int32).max
    base = torch.where(found, r3, big).amin(dim=-1)
    base = torch.where(base == big, 0, base).to(torch.int32)
    off = torch.where(found, r3 - base[..., None], 3)
    clamped = (found & (off > 2)).sum()
    off = off.clamp(max=3).to(torch.int32)
    sel = off[..., 0] | (off[..., 1] << 2) | (off[..., 2] << 4)
    return base, sel, clamped


def xwin_selectors(rules, n_in):
    """A kw=3 book's (base, sel), the batched twin of `pcdet_tpu.ops.sparse.
    _xwin_selectors`, and the found taps it had to drop.  On a CUDA tensor
    one launch of `csrc/gather_gemm_xwin.cu:xwin_selectors_kernel`; on a CPU
    tensor `xwin_selectors_plain`.

    :param rules: (B, V, K) int32, K a multiple of 3, misses at `n_in`
    :return: base (B, V, K/3) int32 window starts (0 where no tap is
        found), sel (B, V, K/3) int32 packed 2-bit offsets, clamped (0-dim
        int64 tensor): found taps outside their group's 3-row window, which
        the encoding turns into misses (0 on every book of BackBone8x)
    """
    if rules.dim() != 3 or rules.shape[2] % 3:
        raise ValueError('want a kw=3 book (B, V, 3G), got %s'
                         % (tuple(rules.shape),))
    if rules.dtype != torch.int32 or not rules.is_contiguous():
        raise TypeError('rules must be contiguous int32, got %s' % rules.dtype)
    if rules.device.type == 'cpu':
        return xwin_selectors_plain(rules, n_in)
    b, v, k = rules.shape
    base = torch.empty((b, v, k // 3), dtype=torch.int32, device=rules.device)
    sel = torch.empty_like(base)
    clamped = torch.zeros((), dtype=torch.int64, device=rules.device)
    lib = build()
    with torch.cuda.device(rules.device):
        rc = lib.pcdet_xwin_selectors(
            rules.data_ptr(), int(n_in), base.numel(), base.data_ptr(),
            sel.data_ptr(), clamped.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, rc)
    LAUNCHES['xwin_selectors'] += 1
    return base, sel, clamped


def rules_from_xwin(base, sel, n_in):
    """(base, sel) -> (B, V, 3G) int32 rules, misses at `n_in`."""
    taps = [(sel >> (2 * dx)) & 3 for dx in range(3)]
    r = torch.stack([torch.where(t == 3, n_in, base + t) for t in taps], -1)
    return r.reshape(*base.shape[:-1], -1).to(torch.int32)


def segment_desc(base, sel, tile=TILE, s=SEG_S):
    """Per-(tile, group) segment descriptors, the batched twin of
    `pcdet_tpu.ops.pallas.gather_gemm.segment_desc`.

    :param base, sel: (B, V, G) int32; rows past V count as all-miss
    :return: anchor (B, n_tiles, G) int32 least window start over the
        tile's rows with a tap; ok (B, n_tiles, G) int32, the span (greatest
        start + 3, less the anchor) at most `s`; seloff (B, V, G) int32,
        per x-tap the 10-bit row offset into the segment (1023: a miss),
        0 on the rows of tiles that are not ok
    """
    if not 1 <= s <= SEG_MISS - 1:
        raise ValueError('segment rows must be in 1..%d, got %d'
                         % (SEG_MISS - 1, s))
    b, v, g = base.shape
    n_tiles = -(-v // tile)
    pad = n_tiles * tile - v
    if pad:
        base = torch.cat([base, base.new_zeros((b, pad, g))], 1)
        sel = torch.cat([sel, sel.new_full((b, pad, g), NO_TAP)], 1)
    b4 = base.reshape(b, n_tiles, tile, g)
    s4 = sel.reshape(b, n_tiles, tile, g)
    miss = s4 == NO_TAP
    big = torch.iinfo(torch.int32).max
    lo = torch.where(miss, big, b4).amin(dim=2)
    anchor = torch.where(lo == big, 0, lo).to(torch.int32)
    hi = torch.where(miss, -1, b4 + 3).amax(dim=2)
    ok = (hi - anchor) <= s
    rel = b4 - anchor[:, :, None]
    seloff = torch.zeros_like(b4)
    for dx in range(3):
        tap = (s4 >> (2 * dx)) & 3
        o = torch.where(tap == 3, SEG_MISS, (rel + tap).clamp(0, SEG_MISS))
        seloff = seloff | (o << (10 * dx))
    seloff = torch.where(ok[:, :, None], seloff, 0)
    return (anchor, ok.to(torch.int32),
            seloff.reshape(b, n_tiles * tile, g)[:, :v].to(torch.int32))


def rules_from_segment(anchor, ok, seloff, base, sel, n_in, tile=TILE):
    """The rules a segment kernel reads: anchor + offset on the tiles that
    are ok, `rules_from_xwin` on the others; (B, V, 3G) int32."""
    b, v, g = base.shape
    row_ok = ok.repeat_interleave(tile, dim=1)[:, :v] > 0      # (B, V, G)
    row_anchor = anchor.repeat_interleave(tile, dim=1)[:, :v]
    seg = []
    for dx in range(3):
        o = (seloff >> (10 * dx)) & SEG_MISS
        seg.append(torch.where(o == SEG_MISS, n_in, row_anchor + o))
    seg = torch.stack(seg, -1).reshape(b, v, 3 * g).to(torch.int32)
    row_ok = row_ok.repeat_interleave(3, dim=-1)
    return torch.where(row_ok, seg, rules_from_xwin(base, sel, n_in))


def gather_gemm_xwin_plain(feats, base, sel, weights, n_live):
    """E's plain version: `gather_gemm_plain` over `rules_from_xwin`."""
    return gather_gemm_plain(feats, rules_from_xwin(base, sel,
                                                    feats.shape[1] - 1),
                             weights, n_live)


def gather_gemm_seg_plain(feats, base, sel, weights, n_live, s=SEG_S):
    """E′'s plain version: `gather_gemm_plain` over the rules rebuilt from
    `segment_desc` and the selectors."""
    anchor, ok, seloff = segment_desc(base, sel, TILE, s)
    rules = rules_from_segment(anchor, ok, seloff, base, sel,
                               feats.shape[1] - 1)
    return gather_gemm_plain(feats, rules, weights, n_live)


def _layout(bf16, cin, cout):
    """(staged row bytes, W bytes per x-tap) of an E / E′ instance:
    `csrc/gather_gemm_xwin.cu:Layout`.  f32 rows are padded by 16 bytes
    where a quarter-warp reads two rows (Cout 16), bf16 rows always (for
    ldmatrix); bf16 Cin 4 is staged as 16 channels."""
    size = 2 if bf16 else 4
    cin_s = 16 if bf16 and cin < 16 else cin
    raw = cin_s * size
    pad = (bf16 or cout < 32) and raw > 16
    return raw + 16 * pad, cin_s * (cout * size + 16 * bf16)


def stages(dtype, cin, cout):
    """(W stages, row stages) of an instance, `Layout::kWStages` /
    `kRowStages`: (3, 2) where they fit a block at S = 256 and 21 groups,
    else (2, 1) (f32 (128, 64) and (64, 128))."""
    row, w = _layout(dtype == torch.bfloat16, cin, cout)
    fits = (16 + 3 * w + row + 4 * MAX_GROUPS * (2 * TILE + 2)
            + 2 * SEG_S * row) <= SMEM_LIMIT
    return (3, 2) if fits else (2, 1)


def smem_bytes(dtype, cin, cout, s, groups):
    """`Layout::smem_bytes`: the dynamic shared memory of one E′ block
    (64 rows) at `s` segment rows (E: s = 0) and `groups` tap groups: a
    16-byte header, the W ring of `stages`' x-taps, the zero row, its row
    stages of max(s, 192) staged rows each, the selectors of 64 rows and
    each group's anchor and span."""
    row, w = _layout(dtype == torch.bfloat16, cin, cout)
    w_stages, row_stages = stages(dtype, cin, cout)
    return (16 + w_stages * w + row + 4 * groups * (2 * TILE + 2)
            + row_stages * max(s, 3 * TILE) * row)


def max_seg_rows(dtype, cin, cout):
    """The most segment rows the card's E′ instance stages: the largest s
    (at most 1022) whose `smem_bytes` at 21 groups fits a block."""
    row, _ = _layout(dtype == torch.bfloat16, cin, cout)
    row_stages = stages(dtype, cin, cout)[1]
    fixed = (smem_bytes(dtype, cin, cout, 0, MAX_GROUPS)
             - row_stages * 3 * TILE * row)
    return min(SEG_MISS - 1, (SMEM_LIMIT - fixed) // (row_stages * row))


@functools.cache
def build():
    """Build (or reuse) and load the kernel library; returns it."""
    lib = cuda_build.load_library('gather_gemm_xwin', _SOURCES)
    fn = lib.pcdet_gather_gemm_xwin
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sel = lib.pcdet_xwin_selectors
    sel.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] \
        + [ctypes.c_void_p] * 4
    sel.restype = ctypes.c_int
    lib.pcdet_gather_gemm_xwin_max_seg_rows.argtypes = [ctypes.c_int] * 3
    lib.pcdet_gather_gemm_xwin_max_seg_rows.restype = ctypes.c_int
    lib.pcdet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pcdet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tally(device):
    """The segment kernels' (segment, window) branch counter on `device`."""
    key = str(torch.device(device))
    if key not in _TALLY:
        # a normal tensor even when the first launch runs under
        # inference_mode, so that `reset_seg_tiles` may zero it anywhere
        with torch.inference_mode(False):
            _TALLY[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _TALLY[key]


def reset_seg_tiles():
    for t in _TALLY.values():
        t.zero_()


def seg_tiles():
    """{'segment': n, 'window': n} (tile, group)s of E′ and D′ launches since
    `reset_seg_tiles`, summed over devices (synchronises)."""
    out = [0, 0]
    for t in _TALLY.values():
        seg, win = t.tolist()
        out[0] += seg
        out[1] += win
    return {'segment': out[0], 'window': out[1]}


def check_selectors(feats, base, sel, weights, n_live, tail, tail_name):
    """Shapes, dtypes, devices and contiguity of a selector-driven call;
    `tail` is the (B, V_out, Cout) gradient of a dW call, else None."""
    if feats.dim() != 3 or base.dim() != 3 or sel.dim() != 3:
        raise ValueError('want feats (B, V_in+1, Cin), base and sel (B, V_out,'
                         ' G); got %s, %s, %s' % (tuple(feats.shape),
                                                  tuple(base.shape),
                                                  tuple(sel.shape)))
    b, v_out, g = base.shape
    if (tuple(sel.shape) != (b, v_out, g) or feats.shape[0] != b
            or tuple(n_live.shape) != (b,)
            or (weights is not None and (weights.dim() != 3
                                         or weights.shape[0] != 3 * g
                                         or weights.shape[1]
                                         != feats.shape[2]))
            or (tail is not None and (tail.dim() != 3 or tuple(tail.shape[:2])
                                      != (b, v_out)))):
        raise ValueError('shapes disagree: feats %s, base %s, sel %s, %s %s, '
                         'n_live %s' % (
                             tuple(feats.shape), tuple(base.shape),
                             tuple(sel.shape), tail_name,
                             tuple((weights if tail is None else tail).shape),
                             tuple(n_live.shape)))
    other = weights if tail is None else tail
    cuda_build.check_operands(
        (('base', base), ('sel', sel), ('n_live', n_live)),
        (('feats', feats), (tail_name, other)))
    if b > _MAX_GRID_Y or feats.shape[1] * feats.shape[2] >= 2 ** 31 \
            or v_out * max(3 * g, other.shape[-1]) >= 2 ** 31:
        raise ValueError('batch or table too large: B=%d V_in+1=%d V_out=%d'
                         % (b, feats.shape[1], v_out))
    if not 1 <= g <= MAX_GROUPS:
        raise ValueError('want 1..%d tap groups, got %d' % (MAX_GROUPS, g))


def _gather(seg, feats, base, sel, weights, n_live, s, dgrad):
    check_selectors(feats, base, sel, weights, n_live, None, 'weights')
    if feats.dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError('feats must be float32 or bfloat16, got %s'
                        % feats.dtype)
    if weights.dtype != feats.dtype:
        raise TypeError('weights (%s) must have the dtype of feats (%s)'
                        % (weights.dtype, feats.dtype))
    if seg and not 1 <= s <= SEG_MISS - 1:
        raise ValueError('segment rows must be in 1..%d, got %d'
                         % (SEG_MISS - 1, s))
    if feats.device.type == 'cpu':
        if seg:
            return gather_gemm_seg_plain(feats, base, sel, weights, n_live, s)
        return gather_gemm_xwin_plain(feats, base, sel, weights, n_live)
    if feats.device.type != 'cuda':
        raise ValueError('unsupported device %s' % feats.device)
    if feats.dtype == torch.float64:
        raise TypeError('no float64 kernel: float64 runs on the CPU only')
    b, v_out, g = base.shape
    cin, cout = feats.shape[2], weights.shape[2]
    if (cin, cout) not in PAIRS:
        raise ValueError('no kernel instance for Cin=%d, Cout=%d (pairs %s)'
                         % (cin, cout, PAIRS))
    bf16 = feats.dtype == torch.bfloat16
    if seg and s > max_seg_rows(feats.dtype, cin, cout):
        raise ValueError('the card stages at most %d segment rows at (%s, %d,'
                         ' %d), got %d' % (max_seg_rows(feats.dtype, cin,
                                                        cout),
                                           feats.dtype, cin, cout, s))
    lib = build()
    out = torch.empty((b, v_out, cout), dtype=torch.float32,
                      device=feats.device)
    if out.numel() == 0:
        return out
    counter = tally(feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcdet_gather_gemm_xwin(
            int(seg), int(bf16), feats.data_ptr(), base.data_ptr(),
            sel.data_ptr(), weights.data_ptr(), n_live.data_ptr(),
            out.data_ptr(), counter.data_ptr(), b, feats.shape[1], v_out, g,
            cin, cout, s, stream)
    cuda_build.check(lib, rc)
    name = 'gather_gemm_%s_%s' % ('seg' if seg else 'xwin',
                                  'bf16' if bf16 else 'f32')
    LAUNCHES[name + ('_dgrad' if dgrad else '')] += 1
    PAIR_LAUNCHES[name, cin, cout] = PAIR_LAUNCHES.get((name, cin, cout),
                                                       0) + 1
    return out


def gather_gemm_xwin(feats, base, sel, weights, n_live, dgrad=False):
    """Kernel E.

    :param feats: (B, V_in + 1, Cin) f32 or bf16; row V_in of every sample
        is zeros
    :param base, sel: (B, V_out, G) int32 selectors (`xwin_selectors`)
    :param weights: (3G, Cin, Cout), the dtype of feats
    :param n_live: (B,) int32 live output rows (a prefix); rows past it are
        zero
    :param dgrad: count the launch as a feature gradient's
    :return: (B, V_out, Cout) f32
    """
    return _gather(False, feats, base, sel, weights, n_live, 0, dgrad)


def gather_gemm_seg(feats, base, sel, weights, n_live, s=SEG_S, dgrad=False):
    """Kernel E′: `gather_gemm_xwin`'s contract, `s` segment rows
    (1..1022 on the CPU, 1..`max_seg_rows` on the card)."""
    return _gather(True, feats, base, sel, weights, n_live, s, dgrad)
