"""Rotated-rectangle intersection areas over a batched pair grid.

`pair_overlap_batched` replaces the TPU kernel
`pcdet_tpu.ops.pallas.rotated_overlap.pair_overlap_batched`.  On a CUDA
tensor it launches the hand-written kernel `csrc/rotated_overlap.cu` (built
with nvcc at first use) or raises; on a CPU tensor it computes the plain
version, `pair_overlap_batched_plain`.  There is no fallback from the one to
the other.

`LAUNCHES` counts kernel launches, so a run can show that its path went
through the kernel.
"""
import ctypes
import functools

import torch

from . import cuda_build, rotated_iou

LAUNCHES = 0
_SOURCES = ('rotated_overlap.cu',)
_MAX_GRID_YZ = 65535
_ROWS_PER_BLOCK = 4     # kRowsM in the kernel


@functools.cache
def build():
    """Build (or reuse) and load the kernel library; returns it."""
    lib = cuda_build.load_library('rotated_overlap', _SOURCES)
    fn = lib.pcdet_rotated_overlap_batched
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pcdet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pcdet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def pair_overlap_batched_plain(corners_a, corners_b):
    """(G, M, 4, 2) x (G, N, 4, 2) -> (G, M, N) areas, in plain PyTorch."""
    return rotated_iou.quad_intersection_area(corners_a[:, :, None],
                                              corners_b[:, None])


def _check(corners_a, corners_b):
    for name, t in (('corners_a', corners_a), ('corners_b', corners_b)):
        if t.dim() != 4 or t.shape[2:] != (4, 2):
            raise ValueError('%s must be (G, *, 4, 2), got %s'
                             % (name, tuple(t.shape)))
        if t.dtype != torch.float32:
            raise TypeError('%s must be float32, got %s' % (name, t.dtype))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    if corners_a.shape[0] != corners_b.shape[0]:
        raise ValueError('group counts differ: %d vs %d'
                         % (corners_a.shape[0], corners_b.shape[0]))
    if corners_a.device != corners_b.device:
        raise ValueError('corners on different devices: %s vs %s'
                         % (corners_a.device, corners_b.device))


def pair_overlap_batched(corners_a, corners_b):
    """(G, M, 4, 2) x (G, N, 4, 2) f32 CCW corners -> (G, M, N) f32
    intersection areas; independent pair problems per group."""
    global LAUNCHES
    _check(corners_a, corners_b)
    if corners_a.device.type == 'cpu':
        return pair_overlap_batched_plain(corners_a, corners_b)
    if corners_a.device.type != 'cuda':
        raise ValueError('unsupported device %s' % corners_a.device)
    g, m, n = corners_a.shape[0], corners_a.shape[1], corners_b.shape[1]
    if g > _MAX_GRID_YZ or -(-m // _ROWS_PER_BLOCK) > _MAX_GRID_YZ:
        raise ValueError('grid too large: G=%d M=%d' % (g, m))
    if n >= 2 ** 31:
        raise ValueError('N=%d does not fit the kernel\'s int' % n)
    lib = build()
    out = torch.empty((g, m, n), dtype=torch.float32, device=corners_a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(corners_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcdet_rotated_overlap_batched(
            corners_a.data_ptr(), corners_b.data_ptr(), out.data_ptr(),
            g, m, n, stream)
    cuda_build.check(lib, rc)
    LAUNCHES += 1
    return out


def pair_overlap(corners_a, corners_b):
    """(M, 4, 2) x (N, 4, 2) -> (M, N): the G = 1 case of the same kernel."""
    return pair_overlap_batched(corners_a[None], corners_b[None])[0]
