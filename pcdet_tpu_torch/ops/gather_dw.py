"""Weight gradient of the rulebook sparse convolutions (kernel D).

    dW[k] = sum_b sum_{v < n_live[b]} feats[b, rules[b, v, k]] (outer) g[b, v]

`gather_dw` replaces `pcdet_tpu.ops.pallas.gather_gemm.gather_dw` (D) and
computes what its segment- and window-load variants `gather_dw_seg` (D′)
and `gather_dw_xwin` (D″) compute.  JAX vmaps those per sample and sums
the weight's cotangent; here the kernel sums over the batch itself.  On a
CUDA tensor it launches the hand-written kernel `csrc/gather_dw.cu` (built
with nvcc at first use) or raises; on a CPU tensor it computes the plain
version, `gather_dw_plain`.  There is no fallback from the one to the other.

The kernel writes one partial per (sample, row chunk, tap) and sums them in
a fixed order in a second launch: two calls on the same inputs give the
same bits.

`LAUNCHES` counts kernel launches, so a run can show that its path went
through the kernel.
"""
import ctypes
import functools

import torch

from . import cuda_build

LAUNCHES = {'gather_dw': 0}
# (Cin, Cout) of the kernel's instances: the forward pairs of BackBone8x
PAIRS = ((4, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64), (64, 128))
MAX_TAPS = 64
_ROWS = 64                   # the kernel's sub-tile; chunks are multiples
_MAX_CHUNK_TILES = 32
_TARGET_BLOCKS = 4 * 132     # a few blocks per SM of an H100
_SOURCES = ('gather_dw.cu',)


@functools.cache
def build():
    """Build (or reuse) and load the kernel library; returns it."""
    lib = cuda_build.load_library('gather_dw', _SOURCES)
    fn = lib.pcdet_gather_dw
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pcdet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pcdet_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    if feats.dtype != g.dtype or feats.dtype not in (torch.float32,
                                                     torch.float64):
        raise TypeError('feats and g must be float32 (float64 on the CPU), '
                        'got %s and %s' % (feats.dtype, g.dtype))
    if rules.dtype != torch.int32 or n_live.dtype != torch.int32:
        raise TypeError('rules and n_live must be int32, got %s and %s'
                        % (rules.dtype, n_live.dtype))
    devices = {t.device for t in (feats, rules, g, n_live)}
    if len(devices) != 1:
        raise ValueError('tensors on different devices: %s' % sorted(
            str(d) for d in devices))
    for name, t in (('feats', feats), ('rules', rules), ('g', g),
                    ('n_live', n_live)):
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)


def chunk_rows(b, v_out, k):
    """Rows per block of the kernel's first pass: enough chunks that the
    (chunk, tap, sample) grid fills the card, at most 32 sub-tiles each."""
    tiles = -(-v_out // _ROWS)
    n_chunks = -(-_TARGET_BLOCKS // (k * b))
    per_chunk = max(1, min(_MAX_CHUNK_TILES, -(-tiles // n_chunks)))
    return per_chunk * _ROWS


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
    if feats.dtype != torch.float32:
        raise TypeError('no float64 kernel: float64 runs on the CPU only')
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
    rows = chunk_rows(b, v_out, k)
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
    return out
