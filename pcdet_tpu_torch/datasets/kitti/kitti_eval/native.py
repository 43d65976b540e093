"""ctypes bindings of the KITTI evaluator's native functions.

The port's copy of `pcdet_tpu.native`'s evaluator entries (`rotate_iou_eval`,
`image_box_overlap`, `compute_statistics`, `fused_compute_statistics`) over
`csrc/kitti_eval_native.cpp`, built with g++ at first use into
`build/pcdet_tpu_torch/`.  Everything stays on the host in f64, as in
`pcdet_tpu`.  The library is required: a failed build raises.
"""
import ctypes
import functools

import numpy as np

from ....ops.cuda_build import build_host_library, host_library_path

_SOURCE = 'kitti_eval_native.cpp'


@functools.cache
def get_lib():
    """Build (once per source hash) and load the evaluator library."""
    path = host_library_path('kitti_eval', _SOURCE)
    build_host_library(path, _SOURCE)
    lib = ctypes.CDLL(str(path))
    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_long_p = ctypes.POINTER(ctypes.c_long)
    lib.rotate_iou_eval.argtypes = [c_double_p, ctypes.c_long, c_double_p,
                                    ctypes.c_long, ctypes.c_int, c_double_p]
    lib.image_box_overlap.argtypes = [c_double_p, ctypes.c_long, c_double_p,
                                      ctypes.c_long, ctypes.c_int, c_double_p]
    lib.compute_statistics.argtypes = [
        c_double_p, ctypes.c_long, ctypes.c_long, c_double_p, c_double_p,
        c_long_p, c_long_p, c_double_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        c_double_p, c_double_p, c_long_p]
    lib.fused_compute_statistics.argtypes = [
        c_double_p, ctypes.c_long, c_double_p, c_long_p, c_long_p, c_long_p,
        ctypes.c_long, c_double_p, c_double_p, c_double_p, c_long_p, c_long_p,
        ctypes.c_int, ctypes.c_double, c_double_p, ctypes.c_long, ctypes.c_int]
    for fn in (lib.rotate_iou_eval, lib.image_box_overlap,
               lib.compute_statistics, lib.fused_compute_statistics):
        fn.restype = None
    return lib


def _as_c(arr, dtype):
    arr = np.ascontiguousarray(arr, dtype=dtype)
    ptr_type = ctypes.POINTER(ctypes.c_double if dtype == np.float64
                              else ctypes.c_long)
    return arr, arr.ctypes.data_as(ptr_type)


def _dptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def rotate_iou_eval(boxes, qboxes, criterion=-1):
    """(N,5)[x,y,dx,dy,ang] x (K,5) -> (N,K) rotated IoU (criterion -1),
    intersection over the first (0) or second (1) area, or the raw
    intersection (2)."""
    boxes, bp = _as_c(boxes, np.float64)
    qboxes, qp = _as_c(qboxes, np.float64)
    n, k = boxes.shape[0], qboxes.shape[0]
    out = np.zeros((n, k), dtype=np.float64)
    get_lib().rotate_iou_eval(bp, n, qp, k, int(criterion), _dptr(out))
    return out


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """(N,4) x (K,4) axis-aligned image boxes -> (N,K) overlap."""
    boxes, bp = _as_c(boxes, np.float64)
    query_boxes, qp = _as_c(query_boxes, np.float64)
    n, k = boxes.shape[0], query_boxes.shape[0]
    out = np.zeros((n, k), dtype=np.float64)
    if n and k:
        get_lib().image_box_overlap(bp, n, qp, k, int(criterion), _dptr(out))
    return out


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Single-frame matching statistics (eval.py compute_statistics_jit).

    :param overlaps: (det, gt) float64
    :return: tp, fp, fn, similarity, thresholds (np array)
    """
    det_size, gt_size = dt_datas.shape[0], gt_datas.shape[0]
    overlaps, op = _as_c(overlaps, np.float64)
    gt_datas, gp = _as_c(gt_datas, np.float64)
    dt_datas, dp = _as_c(dt_datas, np.float64)
    ignored_gt, igp = _as_c(ignored_gt, np.int64)
    ignored_det, idp = _as_c(ignored_det, np.int64)
    dc_bboxes, dcp = _as_c(dc_bboxes.reshape(-1, 4) if dc_bboxes.size
                           else np.zeros((0, 4)), np.float64)
    out4 = np.zeros(4, dtype=np.float64)
    out_thresh = np.zeros(max(gt_size, 1), dtype=np.float64)
    n_thresh = np.zeros(1, dtype=np.int64)
    get_lib().compute_statistics(
        op, det_size, gt_size, gp, dp, igp, idp, dcp, dc_bboxes.shape[0],
        int(metric), float(min_overlap), float(thresh), int(compute_fp),
        int(compute_aos), _dptr(out4), _dptr(out_thresh),
        n_thresh.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    return (int(out4[0]), int(out4[1]), int(out4[2]), out4[3],
            out_thresh[:n_thresh[0]])


def fused_compute_statistics(overlaps, pr, gt_nums, dt_nums, dc_nums,
                             gt_datas, dt_datas, dontcares, ignored_gts,
                             ignored_dets, metric, min_overlap, thresholds,
                             compute_aos=False):
    """Accumulate the PR counts of frames x thresholds into `pr` (T, 4)."""
    overlaps, op = _as_c(overlaps, np.float64)
    pr_c = np.ascontiguousarray(pr, dtype=np.float64)
    gt_nums, gnp = _as_c(gt_nums, np.int64)
    dt_nums, dnp = _as_c(dt_nums, np.int64)
    dc_nums, dcp = _as_c(dc_nums, np.int64)
    gt_datas, gp = _as_c(gt_datas, np.float64)
    dt_datas, dp = _as_c(dt_datas, np.float64)
    dontcares, dop = _as_c(dontcares.reshape(-1, 4) if dontcares.size
                           else np.zeros((0, 4)), np.float64)
    ignored_gts, igp = _as_c(ignored_gts, np.int64)
    ignored_dets, idp = _as_c(ignored_dets, np.int64)
    thresholds, tp = _as_c(thresholds, np.float64)
    get_lib().fused_compute_statistics(
        op, overlaps.shape[1], _dptr(pr_c), gnp, dnp, dcp, len(gt_nums), gp,
        dp, dop, igp, idp, int(metric), float(min_overlap), tp,
        len(thresholds), int(compute_aos))
    pr[:] = pr_c
