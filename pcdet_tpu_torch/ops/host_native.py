"""ctypes bindings of the data pipeline's native host functions.

The port's copies of `pcdet_tpu.native`'s `voxelize` (csrc/
voxelizer_native.cpp: spconv's VoxelGenerator, one pass with a hash table,
first-appearance voxel order) and of `noise_per_box` and
`points_in_rbboxes` (csrc/augmentation_native.cpp: the per-object noise's
first-success collision search, the point-in-rotated-box mask).  Each
source is built with g++ at first use into `build/pcdet_tpu_torch/`, with
`pcdet_tpu`'s flags, so that the float trigonometry selects the same tries.
The libraries are required: a failed build raises, and there is no numpy
stand-in.
"""
import ctypes
import functools

import numpy as np

from .cuda_build import build_host_library, host_library_path

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int)
_i64p = ctypes.POINTER(ctypes.c_long)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _load(name, source):
    path = host_library_path(name, source)
    build_host_library(path, source)
    return ctypes.CDLL(str(path))


@functools.cache
def voxelizer_lib():
    """Build (once per source hash) and load the host voxelizer."""
    lib = _load('voxelizer', 'voxelizer_native.cpp')
    lib.voxelize.argtypes = [
        _f32p, ctypes.c_long, ctypes.c_int, _f32p, _f32p, _i64p, ctypes.c_int,
        ctypes.c_long, _f32p, _i32p, _i32p, _i64p]
    lib.voxelize.restype = ctypes.c_long
    return lib


@functools.cache
def augmentation_lib():
    """Build (once per source hash) and load the augmentation functions."""
    lib = _load('augmentation', 'augmentation_native.cpp')
    lib.noise_per_box_native.argtypes = [
        _f32p, _u8p, _f32p, _f32p, ctypes.c_long, ctypes.c_long, _i64p]
    lib.noise_per_box_native.restype = None
    lib.points_in_rbboxes_native.argtypes = [
        _f32p, ctypes.c_long, ctypes.c_long, _f32p, ctypes.c_long, _u8p]
    lib.points_in_rbboxes_native.restype = None
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctype)


def voxelize(points, voxel_size, pc_range_min, grid_size, max_pts,
             max_voxels):
    """Voxels of `points` (P, C) f32, xyz first, in first-appearance order.

    :return: dict voxels (max_voxels, max_pts, C) f32, coordinates
        (max_voxels, 3) int32 ZYX, num_points_per_voxel (max_voxels,) int32,
        num_voxels, voxel_pt_indices_into_original_pt_cloud (max_voxels,
        max_pts) int64 (-1 pad); rows past num_voxels are padding
    """
    points = np.ascontiguousarray(points, dtype=np.float32)
    p, c = points.shape
    voxels = np.empty((max_voxels, max_pts, c), dtype=np.float32)
    coords = np.empty((max_voxels, 3), dtype=np.int32)
    num_points = np.empty(max_voxels, dtype=np.int32)
    pt_indices = np.empty((max_voxels, max_pts), dtype=np.int64)
    vs = np.ascontiguousarray(voxel_size, dtype=np.float32)
    rmin = np.ascontiguousarray(pc_range_min, dtype=np.float32)
    gs = np.ascontiguousarray(grid_size, dtype=np.int64)
    n_vox = voxelizer_lib().voxelize(
        _ptr(points, _f32p), p, c, _ptr(vs, _f32p), _ptr(rmin, _f32p),
        _ptr(gs, _i64p), int(max_pts), int(max_voxels), _ptr(voxels, _f32p),
        _ptr(coords, _i32p), _ptr(num_points, _i32p),
        _ptr(pt_indices, _i64p))
    return {
        'voxels': voxels,
        'coordinates': coords,
        'num_points_per_voxel': num_points,
        'num_voxels': int(n_vox),
        'voxel_pt_indices_into_original_pt_cloud': pt_indices,
    }


def noise_per_box(boxes, valid_mask, loc_noises, rot_noises):
    """First-success per-object noise search.

    :param boxes: (N, 5) [x, y, dx, dy, rot]
    :return: (N,) int64, the try selected for each box, or -1
    """
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    valid = np.ascontiguousarray(valid_mask, dtype=np.uint8)
    loc = np.ascontiguousarray(loc_noises, dtype=np.float32)
    rot = np.ascontiguousarray(rot_noises, dtype=np.float32)
    n, t = rot.shape
    selected = np.empty((n,), dtype=np.int64)
    augmentation_lib().noise_per_box_native(
        _ptr(boxes, _f32p), _ptr(valid, _u8p), _ptr(loc, _f32p),
        _ptr(rot, _f32p), n, t, _ptr(selected, _i64p))
    return selected


def points_in_rbboxes(points, boxes):
    """(N, P) bool: point j inside box i.

    :param points: (P, C) f32, xyz first
    :param boxes: (N, 7) [x, y, z, w, l, h, rz], z the bottom center
    """
    points = np.ascontiguousarray(points, dtype=np.float32)
    boxes = np.ascontiguousarray(boxes, dtype=np.float32).reshape(-1, 7)
    p, n = points.shape[0], boxes.shape[0]
    mask = np.empty((n, p), dtype=np.uint8)
    augmentation_lib().points_in_rbboxes_native(
        _ptr(points, _f32p), p, points.shape[1], _ptr(boxes, _f32p), n,
        _ptr(mask, _u8p))
    return mask.astype(bool)


def serial_openmp():
    """Run this process's OpenMP regions on one thread.  A worker forked
    from a parent that has run an OpenMP region inherits libgomp's thread
    pool without its threads, and its next parallel region waits for them
    forever; on one thread a region starts no team."""
    try:
        gomp = ctypes.CDLL('libgomp.so.1')
    except OSError:               # the libraries were built without OpenMP
        return
    gomp.omp_set_num_threads(1)
