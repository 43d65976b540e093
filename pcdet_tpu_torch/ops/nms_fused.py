"""Kernel F: exact greedy NMS with every round on the card, one launch a
call (`csrc/nms_fused.cu`).

It replaces no TPU kernel: it fuses kernel A (`rotated_overlap.py`) with the
greedy that `nms._lazy_greedy_batched` runs around A's launches, so that
`nms.nms_bev_batched` on a CUDA tensor reads nothing back on the host.  Its
decisions are the eager loop's bit for bit (the same f32 IoU from A's device
functions, the same 64-box blocks); the eager loop stays as the CPU path and
as F's oracle in the card tests.

`greedy` launches F on CUDA operands or raises; there is no CPU mode.  Each
launch adds 1 to `LAUNCHES` and to `rotated_overlap.LAUNCHES` (F is A's fused
form, rotated or axis-aligned), so A's own launches are the difference.
`plan` picks the launch from pre; `smem_bytes` mirrors the kernel's
shared-memory layout (`Layout` in the source: edit both).
"""
import ctypes
import functools

import torch

from . import cuda_build, rotated_overlap

BLOCK = 64               # kBlock: boxes a round resolves (nms.BLOCK)
CHUNK = 256              # kChunk: alive columns a pair pass covers
REC_FLOATS = 16          # kRec: floats of a block box's record
CLUSTERS = (1, 2, 4, 8, 16)   # CTAs a group; 16 is a non-portable size
SMEM_MAX = 232448        # shared memory one CTA may use on an H100 (227 KB)
MIN_COLS = 128           # the fewest columns a CTA is split down to
_MAX_GRID_Y = 65535
LAUNCHES = 0


def _align16(b):
    return (b + 15) // 16 * 16


def smem_bytes(cols, rotated):
    """Kernel F's shared memory for a CTA of `cols` columns (a multiple of
    32), in bytes: the kernel's `layout`, region for region."""
    words = cols // 32
    regions = (cols * (9 if rotated else 5) * 4,      # staged geometry
               cols * 16 if rotated else 0,            # cull boxes
               cols * 4 if rotated else 0,             # quad kinds
               cols * 4,                               # areas
               cols * 8,                               # row masks
               cols * 2,                               # alive list
               words * 4, words * 4, words * 4,        # alive, keep, prefix
               BLOCK * REC_FLOATS * 4,                 # the block's records
               BLOCK * 8,                              # its greedy masks
               CLUSTERS[-1] * 4,                       # the counts
               BLOCK * CHUNK * 2 if rotated else 0,    # the pair list
               32 * 4)                                 # scalars
    return sum(_align16(b) for b in regions)


def _cols(pre, cluster):
    return -(-(-(-pre // cluster)) // 32) * 32


def plan(pre, rotated):
    """Kernel F's launch for groups of `pre` boxes -> (cluster, cols, smem
    bytes): one cluster a group, its CTAs splitting the columns.  The most
    CTAs (up to 16) that keep at least MIN_COLS columns each, so a round's
    work spreads over as many SMs as it can use; G does not change it (the
    clusters of a large G run in waves).  Raises ValueError when `pre`
    columns do not fit 16 CTAs' shared memory (over 44,032 rotated)."""
    cluster = next((c for c in reversed(CLUSTERS)
                    if -(-pre // c) >= MIN_COLS), CLUSTERS[0])
    cols = _cols(pre, cluster)
    smem = smem_bytes(cols, rotated)
    if smem > SMEM_MAX:
        raise ValueError('pre=%d does not fit kernel F\'s shared memory'
                         % pre)
    return cluster, cols, smem


@functools.cache
def build():
    """Build (or reuse) and load kernel F's library; returns it."""
    lib = cuda_build.load_library('nms_fused', ('nms_fused.cu',))
    lib.pcdet_nms_fused.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    lib.pcdet_nms_fused.restype = ctypes.c_int
    lib.pcdet_nms_fused_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pcdet_nms_fused_smem_bytes.restype = ctypes.c_int
    lib.pcdet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pcdet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def greedy(geo, area, valid, thresh, post_max, rotated):
    """Kernel F over G groups in descending score order -> keep (G, pre)
    bool, rounds (G,) int32 (the rounds each group ran), both on the
    operands' device; nothing is read back.

    :param geo: (G, pre, 4, 2) f32 corners (rotated) or (G, pre, 5) f32
        boxes [x1, y1, x2, y2, ry] (axis-aligned)
    :param area: (G, pre) f32, (x2 - x1) * (y2 - y1)
    :param valid: (G, pre) bool
    Raises ValueError when `pre` does not fit (`plan`)."""
    global LAUNCHES
    if area.dim() != 2 or area.shape != valid.shape:
        raise ValueError('area %s and valid %s must be (G, pre)'
                         % (tuple(area.shape), tuple(valid.shape)))
    g, pre = area.shape
    want = (g, pre, 4, 2) if rotated else (g, pre, 5)
    if tuple(geo.shape) != want:
        raise ValueError('geo %s: want %s' % (tuple(geo.shape), want))
    for name, t, dtype in (('geo', geo, torch.float32),
                           ('area', area, torch.float32),
                           ('valid', valid, torch.bool)):
        if t.dtype != dtype:
            raise TypeError('%s must be %s, got %s' % (name, dtype, t.dtype))
    cuda_build.check_operands((), (('geo', geo), ('area', area),
                                   ('valid', valid)))
    cluster, cols, _ = plan(pre, rotated)
    if g > _MAX_GRID_Y:
        raise ValueError('grid too large: G=%d' % g)
    dev = geo.device
    if dev.type != 'cuda':
        raise ValueError('unsupported device %s: kernel F has no CPU mode'
                         % dev)
    if g == 0 or pre == 0:
        return (torch.zeros((g, pre), dtype=torch.bool, device=dev),
                torch.zeros((g,), dtype=torch.int32, device=dev))
    keep = torch.empty((g, pre), dtype=torch.bool, device=dev)
    rounds = torch.empty((g,), dtype=torch.int32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcdet_nms_fused(
            geo.data_ptr(), area.data_ptr(), valid.data_ptr(),
            keep.data_ptr(), rounds.data_ptr(), g, pre, cluster, cols,
            float(thresh), max(0, min(int(post_max), 2 ** 31 - 1)),
            int(rotated), stream)
    cuda_build.check(lib, rc)
    LAUNCHES += 1
    rotated_overlap.LAUNCHES += 1
    return keep, rounds
