"""Weight gradient of the rulebook sparse convolutions (kernels D, D″, D′).

    dW[k] = sum_b sum_{v < n_live[b]} feats[b, rules[b, v, k]] (outer) g[b, v]

`gather_dw` (D) replaces `pcdet_tpu.ops.pallas.gather_gemm.gather_dw`: per
tap, it loads each output row's table row.  For a kw=3 book given as
x-window selectors (`ops/gather_xwin.xwin_selectors`), `gather_dw_xwin`
(D″, replacing `gather_dw_xwin`) loads each row's 3-row window once per
tap group, and `gather_dw_seg` (D′, replacing `gather_dw_seg`) loads a
64-row tile's whole span once per tap group where it is at most `s` rows,
the windows where it is not.  JAX vmaps those per sample and sums the
weight's cotangent; here each kernel sums over the batch itself.  On a
CUDA tensor each launches its hand-written kernel (`csrc/gather_dw.cu`,
`csrc/gather_dw_xwin.cu`, nvcc at first use) or raises; on a CPU tensor it
computes its plain version: `gather_dw_plain`, and for D″ / D′ the same
over the rules rebuilt from the selectors (and the segment descriptors).
There is no fallback from the one to the other.

Each kernel writes one partial per (sample, row chunk, tap) and sums them
in a fixed order in a second launch: two calls on the same inputs give the
same bits.  A chunk is sized so that the grid of (chunk, block of three
taps, sample) blocks fills a few waves of the blocks the card holds at
once (`chunk_rows`, `resident_blocks`).

`LAUNCHES` counts kernel launches per variant, and `PAIR_LAUNCHES` per
(variant, Cin, Cout), so a run can show that its path went through the
kernels and which instances.
"""
import ctypes
import functools

import torch

from . import cuda_build, gather_xwin

LAUNCHES = {'gather_dw': 0, 'gather_dw_xwin': 0, 'gather_dw_seg': 0}
PAIR_LAUNCHES = {}
# (Cin, Cout) of the kernel's instances: the forward pairs of BackBone8x,
# then those of UNetV2's decoder (conv_up_m4 / m3, conv_up_m2 and inv_conv3,
# conv_up_m1 and inv_conv2)
PAIRS = ((4, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64), (64, 128),
         (128, 64), (64, 32), (32, 16))
MAX_TAPS = 64
_ROWS = 64                   # the kernels' sub-tile; chunks are multiples
_TAPS = 3                    # taps per block (D: 3 of K; D″, D′: a group)
_WAVES = 4                   # waves of resident blocks per launch
_MIN_TILES = 4               # sub-tiles per chunk at least (a fill and a
                             # partial per chunk)
_SOURCES = ('gather_dw.cu',)
_XWIN_SOURCES = ('gather_dw_xwin.cu',)
# (Cin, Cout) of the window and segment instances: the kw=3 convs' pairs
# (all but conv_out's (64, 128))
XWIN_PAIRS = tuple(p for p in PAIRS if p != (64, 128))
SMEM_LIMIT = 232448          # a block's shared memory on sm_90


@functools.cache
def build():
    """Build (or reuse) and load the kernel library; returns it."""
    lib = cuda_build.load_library('gather_dw', _SOURCES)
    fn = lib.pcdet_gather_dw
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pcdet_gather_dw_resident.argtypes = [ctypes.c_int] * 2
    lib.pcdet_gather_dw_resident.restype = ctypes.c_int
    lib.pcdet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pcdet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def row_stages(cin, cout):
    """`Cfg::kRowStages` of the (Cin, Cout) instances: the table rows'
    stages, 2 where they fit a block with D′'s staging at `SEG_S` rows,
    else 1 ((128, 64))."""
    return 2 if smem_bytes('seg', cin, cout, gather_xwin.SEG_S, 2) \
        <= SMEM_LIMIT else 1


def smem_bytes(kind, cin, cout, s=0, stages=None):
    """`Cfg::smem_bytes`: a pass-1 block's dynamic shared memory, `kind`
    'rows' (D), 'xwin' (D″) or 'seg' (D′ at `s` segment rows): two stages
    of the rules or selectors, lists and counts, and of the g rows (64 +
    a zero row, Cout + 4 floats each), and `stages` (None: `row_stages`)
    stages of the staged table rows (Cin, or Cin + 4 from 32 on, floats
    each; 193 slots, or s + 1 for D′ past 192)."""
    rs = cin if cin < 32 else cin + 4
    slots = 3 * _ROWS + 1 if kind != 'seg' else max(s, 3 * _ROWS) + 1
    if stages is None:
        stages = row_stages(cin, cout)
    return 4 * 2 * (2 * _TAPS * _ROWS + 4) + 4 * (
        2 * (_ROWS + 1) * (cout + 4) + stages * slots * rs)


def max_seg_rows(cin, cout):
    """The most segment rows D′'s (Cin, Cout) instance stages in a block
    (at most 1022)."""
    fixed = smem_bytes('seg', cin, cout, 0) - row_stages(cin, cout) * (
        3 * _ROWS + 1) * (cin if cin < 32 else cin + 4) * 4
    per = row_stages(cin, cout) * (cin if cin < 32 else cin + 4) * 4
    return min(gather_xwin.SEG_MISS - 1, (SMEM_LIMIT - fixed) // per - 1)


def gather_dw_plain(feats, rules, g, n_live):
    """The plain PyTorch version: gather, then one einsum over the batch and
    the rows, in the inputs' dtype; rows at or past n_live[b] contribute
    nothing."""
    b, v, _ = rules.shape
    batch = torch.arange(b, device=feats.device)[:, None, None]
    gathered = feats[batch, rules.long()]                    # (B, V, K, Cin)
    live = torch.arange(v, device=feats.device)[None] < n_live[:, None]
    g = torch.where(live[..., None], g, torch.zeros((), dtype=g.dtype,
                                                    device=g.device))
    return torch.einsum('bvki,bvo->kio', gathered, g)


def _check(feats, rules, g, n_live):
    if feats.dim() != 3 or rules.dim() != 3 or g.dim() != 3:
        raise ValueError('want feats (B, V_in+1, Cin), rules (B, V_out, K), '
                         'g (B, V_out, Cout); got %s, %s, %s' % (
                             tuple(feats.shape), tuple(rules.shape),
                             tuple(g.shape)))
    b, v_out, _ = rules.shape
    if (feats.shape[0] != b or tuple(g.shape[:2]) != (b, v_out)
            or tuple(n_live.shape) != (b,)):
        raise ValueError('shapes disagree: feats %s, rules %s, g %s, n_live %s'
                         % (tuple(feats.shape), tuple(rules.shape),
                            tuple(g.shape), tuple(n_live.shape)))
    _check_float(feats, g)
    cuda_build.check_operands((('rules', rules), ('n_live', n_live)),
                              (('feats', feats), ('g', g)))


def _check_float(feats, g):
    if feats.dtype != g.dtype or feats.dtype not in (torch.float32,
                                                     torch.float64):
        raise TypeError('feats and g must be float32 (float64 on the CPU), '
                        'got %s and %s' % (feats.dtype, g.dtype))


def _check_card(feats, g):
    """The kernels' own terms: f32, rows copied in 16-byte pieces."""
    if feats.dtype != torch.float32:
        raise TypeError('no float64 kernel: float64 runs on the CPU only')
    if feats.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError('feats and g must be 16-byte aligned')


def chunk_rows(b, v_out, blocks, resident):
    """Rows per block of a kernel's first pass: the fewest 64-row sub-tiles
    per chunk with which the (chunk, tap block, sample) grid, `blocks` tap
    blocks per sample, fits in `_WAVES` waves of `resident` blocks, and at
    least `_MIN_TILES` (one chunk per sample where even that does not fit).
    Several waves let the card's block scheduler even out chunks that find
    more taps than others."""
    tiles = -(-v_out // _ROWS)
    n_chunks = max(1, min(_WAVES * resident // (blocks * b),
                          tiles // _MIN_TILES))
    return -(-tiles // n_chunks) * _ROWS


@functools.cache
def resident_blocks(device_index, kind, cin, cout, s=0):
    """Pass-1 blocks of an instance resident on card `device_index` at
    once (its SMs times the blocks an SM holds): `kind` 'rows' (D), 'xwin'
    (D″) or 'seg' (D′, `s` segment rows)."""
    with torch.cuda.device(device_index):
        if kind == 'rows':
            lib = build()
            n = lib.pcdet_gather_dw_resident(cin, cout)
        else:
            lib = build_xwin()
            n = lib.pcdet_gather_dw_xwin_resident(int(kind == 'seg'), cin,
                                                  cout, s)
    if n <= 0:
        raise RuntimeError('no block of the %s %d -> %d dW kernel fits on '
                           'the card (S=%d): %s' % (
                               kind, cin, cout, s,
                               lib.pcdet_cuda_error_string(-n).decode()
                               if n else 'none resident'))
    return n


def gather_dw(feats, rules, g, n_live):
    """:param feats: (B, V_in + 1, Cin) f32 (f64 on the CPU, a reference);
        row V_in of every sample is zeros
    :param rules: (B, V_out, K) int32 rows of feats, misses at V_in
    :param g: (B, V_out, Cout) gradient of the conv's output, feats' dtype
    :param n_live: (B,) int32 live output rows (a prefix); rows past it
        contribute nothing
    :return: (K, Cin, Cout) in feats' dtype, summed over the batch
    """
    _check(feats, rules, g, n_live)
    if feats.device.type == 'cpu':
        return gather_dw_plain(feats, rules, g, n_live)
    if feats.device.type != 'cuda':
        raise ValueError('unsupported device %s' % feats.device)
    _check_card(feats, g)
    b, v_out, k = rules.shape
    v_in1, cin = feats.shape[1], feats.shape[2]
    cout = g.shape[2]
    if (cin, cout) not in PAIRS or not 1 <= k <= MAX_TAPS:
        raise ValueError('no kernel instance for Cin=%d, Cout=%d, K=%d '
                         '((Cin, Cout) in %s, K <= %d)' % (
                             cin, cout, k, PAIRS, MAX_TAPS))
    if b > 65535 or max(v_in1 * cin, v_out * max(k, cout)) >= 2 ** 31:
        raise ValueError('batch or table too large: B=%d V_in+1=%d V_out=%d'
                         % (b, v_in1, v_out))
    out = torch.empty((k, cin, cout), dtype=torch.float32, device=feats.device)
    if b == 0 or v_out == 0:
        return out.zero_()
    rows = chunk_rows(b, v_out, -(-k // _TAPS), resident_blocks(
        feats.device.index, 'rows', cin, cout))
    n_chunks = -(-v_out // rows)
    partial = torch.empty((b, n_chunks, k, cin, cout), dtype=torch.float32,
                          device=feats.device)
    lib = build()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcdet_gather_dw(
            feats.data_ptr(), rules.data_ptr(), g.data_ptr(),
            n_live.data_ptr(), partial.data_ptr(), out.data_ptr(), b, v_in1,
            v_out, k, cin, cout, rows, stream)
    cuda_build.check(lib, rc)
    LAUNCHES['gather_dw'] += 1
    _count_pair('gather_dw', cin, cout)
    return out


def _count_pair(name, cin, cout):
    PAIR_LAUNCHES[name, cin, cout] = PAIR_LAUNCHES.get((name, cin, cout),
                                                       0) + 1


@functools.cache
def build_xwin():
    """Build (or reuse) and load D″ and D′'s library; returns it."""
    lib = cuda_build.load_library('gather_dw_xwin', _XWIN_SOURCES)
    fn = lib.pcdet_gather_dw_xwin
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pcdet_gather_dw_xwin_resident.argtypes = [ctypes.c_int] * 4
    lib.pcdet_gather_dw_xwin_resident.restype = ctypes.c_int
    lib.pcdet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pcdet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def gather_dw_xwin_plain(feats, base, sel, g, n_live):
    """D″'s plain version: `gather_dw_plain` over `rules_from_xwin`."""
    return gather_dw_plain(feats, gather_xwin.rules_from_xwin(
        base, sel, feats.shape[1] - 1), g, n_live)


def gather_dw_seg_plain(feats, base, sel, g, n_live, s=gather_xwin.SEG_S):
    """D′'s plain version: `gather_dw_plain` over the rules rebuilt from
    `segment_desc` and the selectors."""
    anchor, ok, seloff = gather_xwin.segment_desc(base, sel,
                                                  gather_xwin.TILE, s)
    rules = gather_xwin.rules_from_segment(anchor, ok, seloff, base, sel,
                                           feats.shape[1] - 1)
    return gather_dw_plain(feats, rules, g, n_live)


def _dw_window(seg, feats, base, sel, g, n_live, s):
    gather_xwin.check_selectors(feats, base, sel, None, n_live, g, 'g')
    _check_float(feats, g)
    if seg and not 1 <= s <= gather_xwin.SEG_MISS - 1:
        raise ValueError('segment rows must be in 1..%d, got %d'
                         % (gather_xwin.SEG_MISS - 1, s))
    if feats.device.type == 'cpu':
        if seg:
            return gather_dw_seg_plain(feats, base, sel, g, n_live, s)
        return gather_dw_xwin_plain(feats, base, sel, g, n_live)
    if feats.device.type != 'cuda':
        raise ValueError('unsupported device %s' % feats.device)
    _check_card(feats, g)
    b, v_out, groups = base.shape
    cin, cout = feats.shape[2], g.shape[2]
    if (cin, cout) not in XWIN_PAIRS:
        raise ValueError('no kernel instance for Cin=%d, Cout=%d (pairs %s)'
                         % (cin, cout, XWIN_PAIRS))
    if seg and s > max_seg_rows(cin, cout):
        raise ValueError('%d segment rows do not fit the %d -> %d instance '
                         '(at most %d)' % (s, cin, cout,
                                           max_seg_rows(cin, cout)))
    k = 3 * groups
    out = torch.empty((k, cin, cout), dtype=torch.float32, device=feats.device)
    if b == 0 or v_out == 0:
        return out.zero_()
    rows = chunk_rows(b, v_out, groups, resident_blocks(
        feats.device.index, 'seg' if seg else 'xwin', cin, cout,
        s if seg else 0))
    n_chunks = -(-v_out // rows)
    partial = torch.empty((b, n_chunks, k, cin, cout), dtype=torch.float32,
                          device=feats.device)
    counter = gather_xwin.tally(feats.device)
    lib = build_xwin()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcdet_gather_dw_xwin(
            int(seg), feats.data_ptr(), base.data_ptr(), sel.data_ptr(),
            g.data_ptr(), n_live.data_ptr(), partial.data_ptr(),
            out.data_ptr(), counter.data_ptr(), b, feats.shape[1], v_out,
            groups, cin, cout, rows, s, stream)
    cuda_build.check(lib, rc)
    name = 'gather_dw_seg' if seg else 'gather_dw_xwin'
    LAUNCHES[name] += 1
    _count_pair(name, cin, cout)
    return out


def gather_dw_xwin(feats, base, sel, g, n_live):
    """Kernel D″.

    :param feats: (B, V_in + 1, Cin) f32 (f64 on the CPU, a reference);
        row V_in of every sample is zeros
    :param base, sel: (B, V_out, G) int32 selectors of a kw=3 book
    :param g: (B, V_out, Cout) gradient of the conv's output, feats' dtype
    :param n_live: (B,) int32 live output rows (a prefix); rows past it
        contribute nothing
    :return: (3G, Cin, Cout) in feats' dtype, summed over the batch
    """
    return _dw_window(False, feats, base, sel, g, n_live, 0)


def gather_dw_seg(feats, base, sel, g, n_live, s=gather_xwin.SEG_S):
    """Kernel D′: `gather_dw_xwin`'s contract, `s` segment rows (1..1022)."""
    return _dw_window(True, feats, base, sel, g, n_live, s)
