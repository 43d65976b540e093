"""Sparse-conv rulebooks built on the host, uploaded and decoded for the port.

The books (which input row feeds which output row at which kernel tap) are
integer metadata of a batch's sorted voxel coords.  `build_books_batch`
builds them from the coords the voxelizer copies to the host, by the
native C++ builders of `csrc/host_books_native.cpp` (g++ at first use into
`build/pcdet_tpu_torch/`, ctypes; required), or by the numpy builders here
where the masks are not prefixes.  Both give the
books `pcdet_tpu.ops.host_books` gives, bit for bit, in its compact wire
format of `hb_*` arrays: rows uint16 (B, V, K) per sample, the found taps
as one uint32 bitmask per output row, and for a strided conv its output
set (ids, coords, mask) and drop count.  Taps are in `_kernel_offsets`
order, x fastest, so the three x-taps of a (dz, dy) pair are consecutive
(`ops/sparse.xwin_selectors` relies on it).

`upload_books` moves a batch's books to the device in ONE copy and decodes
them there into the gather-GEMM's rules: (B, V_out, K) int32, misses
routed to the input level's zero row V_in; `upload_loader_batch` does so
for a loader batch's voxels, targets and books together, and
`make_batch_transform` builds the books in the loader.

Under `PCDET_HOST_BOOKS=0` (`use_host_books`, read where `pcdet_tpu` reads
it) the books are built on the device instead, from the voxelizer's coords
where they lie (`build_books_device`, over the builders of
`ops/sparse.py`), in `decode_books`' layout with no wire format and no
host copy: the loader builds none (`make_batch_transform` gives None) and
`upload_loader_batch` builds them from the uploaded coords.
"""
import ctypes
import os

import numpy as np
import torch

from .cuda_build import build_host_library, host_library_path

INT_MAX = np.iinfo(np.int32).max

_SUBM_FIELDS = ('rows', 'fnd')
_STRIDED_FIELDS = ('ids', 'crd', 'msk', 'drp', 'rows', 'fnd')
_ALIGN = 16
_NATIVE_SRC = 'host_books_native.cpp'
_NATIVE = {}          # 'lib': the loaded library or None, 'error': why not


def _triple(x):
    if isinstance(x, (tuple, list)):
        return tuple(int(v) for v in x)
    return (int(x),) * 3


def _linearize(coords, shape):
    _, h, w = shape
    return (coords[..., 0].astype(np.int64) * h
            + coords[..., 1].astype(np.int64)) * w + coords[..., 2]


def _kernel_offsets(kernel):
    """Tap order of every book: (dz, dy, dx) with dx fastest."""
    kd, kh, kw = kernel
    return np.asarray([(i, j, l) for i in range(kd) for j in range(kh)
                       for l in range(kw)], dtype=np.int64)


def _out_shape(shape, kernel, stride, padding):
    return tuple((shape[i] + 2 * padding[i] - kernel[i]) // stride[i] + 1
                 for i in range(3))


# --------------------------------------------------------------- native ---

def native_lib():
    """Build (once per source hash) and load the native book builders;
    None where g++ fails, with the reason in `native_error()`."""
    if 'lib' in _NATIVE:
        return _NATIVE['lib']
    path = host_library_path('host_books', _NATIVE_SRC)
    lib, error = None, None
    try:
        build_host_library(path, _NATIVE_SRC)
        lib = ctypes.CDLL(str(path))
        i32p = ctypes.POINTER(ctypes.c_int)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.subm_books_batch.argtypes = (
            [i32p, i32p] + [ctypes.c_int] * 8 + [u16p, u32p])
        lib.subm_books_batch.restype = None
        lib.strided_books_batch.argtypes = (
            [i32p, i32p] + [ctypes.c_int] * 15 + [i32p] * 4 + [u16p, u32p])
        lib.strided_books_batch.restype = None
    except (OSError, RuntimeError) as e:
        lib, error = None, str(e)
    _NATIVE.update(lib=lib, error=error, path=path)
    return lib


def native_error():
    """Why the native builders are unavailable (None if they are built)."""
    native_lib()
    return _NATIVE['error']


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _subm_native(lib, coords, n_valid, shape):
    b, v, _ = coords.shape
    k = 27
    assert v < 65536, v
    rows = np.empty((b, v, k), np.uint16)
    found = np.empty((b, v), np.uint32)
    lib.subm_books_batch(_ptr(coords, ctypes.c_int), _ptr(n_valid, ctypes.c_int),
                         b, v, *shape, 3, 3, 3, _ptr(rows, ctypes.c_uint16),
                         _ptr(found, ctypes.c_uint32))
    return rows, found


def _strided_native(lib, coords, n_valid, shape, kernel, stride, padding,
                    out_cap):
    b, v, _ = coords.shape
    k = int(np.prod(kernel))
    assert v < 65536 and k <= 32 and out_cap < 65536, (v, k, out_cap)
    out_ids = np.empty((b, out_cap), np.int32)
    out_coords = np.empty((b, out_cap, 3), np.int32)
    out_n = np.empty((b,), np.int32)
    dropped = np.empty((b,), np.int32)
    rows = np.empty((b, out_cap, k), np.uint16)
    found = np.empty((b, out_cap), np.uint32)
    i32 = ctypes.c_int
    lib.strided_books_batch(
        _ptr(coords, i32), _ptr(n_valid, i32), b, v, *shape, *kernel,
        *stride, *padding, int(out_cap), _ptr(out_ids, i32),
        _ptr(out_coords, i32), _ptr(out_n, i32), _ptr(dropped, i32),
        _ptr(rows, ctypes.c_uint16), _ptr(found, ctypes.c_uint32))
    return out_ids, out_coords, out_n, dropped, rows, found


def _build_books_batch_native(lib, coords_b, mask_b, sparse_shape, spec):
    flat = {}
    shape = tuple(int(s) for s in sparse_shape)
    cur = np.ascontiguousarray(coords_b, dtype=np.int32)
    n_valid = np.ascontiguousarray(mask_b.sum(axis=1), dtype=np.int32)
    for op in spec:
        if op[0] == 'subm':
            flat['hb_%s_rows' % op[1]], flat['hb_%s_fnd' % op[1]] = \
                _subm_native(lib, cur, n_valid, shape)
            continue
        _, key, kernel, stride, padding, cap = op
        kernel, stride, padding = (_triple(kernel), _triple(stride),
                                   _triple(padding))
        out_ids, out_coords, out_n, dropped, rows, fnd = _strided_native(
            lib, cur, n_valid, shape, kernel, stride, padding, int(cap))
        flat['hb_%s_ids' % key] = out_ids
        flat['hb_%s_crd' % key] = out_coords
        flat['hb_%s_msk' % key] = out_ids < INT_MAX
        flat['hb_%s_drp' % key] = dropped
        flat['hb_%s_rows' % key] = rows
        flat['hb_%s_fnd' % key] = fnd
        cur, n_valid = out_coords, out_n
        shape = _out_shape(shape, kernel, stride, padding)
    return flat


# ---------------------------------------------------------------- numpy ---

def subm_book_np(coords, mask, shape, kernel=(3, 3, 3)):
    """Subm book of one sample: rows (V, K) int32, found (V, K) bool."""
    kernel = _triple(kernel)
    v = coords.shape[0]
    ids = np.where(mask, _linearize(coords, shape), np.int64(INT_MAX))
    center = np.asarray([k // 2 for k in kernel], np.int64)
    eoffs = _kernel_offsets(kernel) - center                   # (K, 3)
    _, h, w = shape
    lin_off = (eoffs[:, 0] * h + eoffs[:, 1]) * w + eoffs[:, 2]
    nc = coords[None, :, :].astype(np.int64) + eoffs[:, None, :]  # (K, V, 3)
    inb = np.all((nc >= 0) & (nc < np.asarray(shape, np.int64)), axis=-1)
    q = ids[None, :] + lin_off[:, None]                           # (K, V)
    idx = np.searchsorted(ids, q).astype(np.int64)
    idx_c = np.minimum(idx, v - 1)
    found = (idx < v) & (np.take(ids, idx_c) == q) & inb & mask[None, :]
    rows = np.clip(idx_c, 0, v - 1).astype(np.int32)
    return np.ascontiguousarray(rows.T), np.ascontiguousarray(found.T)


def strided_book_np(coords, mask, shape, kernel, stride, padding, out_cap):
    """Strided conv output set and forward book of one sample: out_ids (O,)
    int32, out_coords (O, 3) int32, out_mask (O,), dropped () int32, rows
    (O, K) int32, found (O, K) bool."""
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    v = coords.shape[0]
    _, kh, kw = kernel
    out_shape = _out_shape(shape, kernel, stride, padding)
    ncand = tuple(-(-kernel[i] // stride[i]) for i in range(3))
    i_c = coords.astype(np.int64)
    o_lo = [-(-(i_c[:, d] + padding[d] - kernel[d] + 1) // stride[d])
            for d in range(3)]
    o_hi = [(i_c[:, d] + padding[d]) // stride[d] for d in range(3)]
    in_row = np.arange(v, dtype=np.int64)
    cand_ids, cand_origin = [], []
    for dz in range(ncand[0]):
        for dy in range(ncand[1]):
            for dx in range(ncand[2]):
                oz, oy, ox = o_lo[0] + dz, o_lo[1] + dy, o_lo[2] + dx
                val = ((oz <= o_hi[0]) & (oy <= o_hi[1]) & (ox <= o_hi[2])
                       & (oz >= 0) & (oy >= 0) & (ox >= 0)
                       & (oz < out_shape[0]) & (oy < out_shape[1])
                       & (ox < out_shape[2]) & mask)
                oid = (oz * out_shape[1] + oy) * out_shape[2] + ox
                tz = i_c[:, 0] + padding[0] - oz * stride[0]
                ty = i_c[:, 1] + padding[1] - oy * stride[1]
                tx = i_c[:, 2] + padding[2] - ox * stride[2]
                cand_ids.append(np.where(val, oid, np.int64(INT_MAX)))
                cand_origin.append(((tz * kh + ty) * kw + tx) * v + in_row)
    cand_ids = np.concatenate(cand_ids)
    cand_origin = np.concatenate(cand_origin)
    order = np.argsort(cand_ids, kind='stable')
    cs, co = cand_ids[order], cand_origin[order]
    valid = cs < INT_MAX
    first = np.empty_like(valid)
    first[:1] = valid[:1]
    first[1:] = (cs[1:] != cs[:-1]) & valid[1:]
    run_rank = np.cumsum(first) - 1                  # out row per candidate
    dropped = np.int32(max(int(first.sum()) - out_cap, 0))
    out_ids = np.full((out_cap,), INT_MAX, np.int64)
    sel = first & (run_rank < out_cap)
    out_ids[run_rank[sel]] = cs[sel]
    out_mask = out_ids < INT_MAX
    out_coords = np.full((out_cap, 3), -1, np.int32)
    plane = out_shape[1] * out_shape[2]
    full = np.stack([out_ids // plane, (out_ids % plane) // out_shape[2],
                     out_ids % out_shape[2]], axis=-1)
    out_coords[out_mask] = full[out_mask]
    k_total = int(np.prod(kernel))
    rows = np.zeros((out_cap, k_total), np.int32)
    found = np.zeros((out_cap, k_total), bool)
    keep = valid & (run_rank < out_cap)
    rows[run_rank[keep], co[keep] // v] = (co[keep] % v).astype(np.int32)
    found[run_rank[keep], co[keep] // v] = True
    return (out_ids.astype(np.int32), out_coords, out_mask, dropped, rows,
            found)


def _pack_found(found):
    """(.., K) bool -> (..,) uint32, bit t = tap t."""
    k = found.shape[-1]
    bits = (found.astype(np.uint32)
            << np.arange(k, dtype=np.uint32)).sum(axis=-1, dtype=np.uint64)
    return bits.astype(np.uint32)


def _books_sample_np(coords, mask, sparse_shape, spec):
    """One sample's books in the wire format, by the numpy builders."""
    flat = {}
    shape = tuple(int(s) for s in sparse_shape)
    for op in spec:
        if op[0] == 'subm':
            rows, found = subm_book_np(coords, mask, shape)
            flat['hb_%s_rows' % op[1]] = rows.astype(np.uint16)
            flat['hb_%s_fnd' % op[1]] = _pack_found(found)
            continue
        _, key, kernel, stride, padding, cap = op
        out_ids, coords, mask, dropped, rows, found = strided_book_np(
            coords, mask, shape, kernel, stride, padding, int(cap))
        for name, arr in zip(_STRIDED_FIELDS, (
                out_ids, coords, mask, np.int32(dropped),
                rows.astype(np.uint16), _pack_found(found))):
            flat['hb_%s_%s' % (key, name)] = np.asarray(arr)
        shape = _out_shape(shape, _triple(kernel), _triple(stride),
                           _triple(padding))
    return flat


# ------------------------------------------------------------------ API ---

def use_host_books():
    """False under PCDET_HOST_BOOKS=0: the sparse models' books are built on
    the device (`build_books_device`), as `pcdet_tpu`'s loader then leaves
    them to the step (`pcdet_tpu.ops.host_books.make_batch_transform`).
    Read at each call."""
    return os.environ.get('PCDET_HOST_BOOKS', '1') != '0'


def build_books_device(coords, mask, sparse_shape, spec):
    """Every book of `spec` for a batch, built where `coords` lie: the
    decoded books of `decode_books` (bit for bit those of `upload_books(
    build_books_batch(..))`), by the builders of `ops/sparse.py`, which
    walk the spec as `_build_books_batch_native` does (each subm book on the
    level of the strided book before it).  No host sync.

    :param coords: (B, V, 3) int ZYX sorted by linear id, -1 padded
    :param mask: (B, V) bool live voxels, a prefix per sample
    """
    from . import sparse
    shape = tuple(int(s) for s in sparse_shape)
    ids = torch.where(mask, sparse.linearize(coords.to(torch.int64), shape),
                      int(INT_MAX)).to(torch.int32)
    level = sparse.SparseLevel(None, ids, coords, mask, shape)
    books = {}
    for op in spec:
        if op[0] == 'subm':
            books[op[1]] = sparse.subm_rules(level)
            continue
        _, key, kernel, stride, padding, cap = op
        books[key] = sparse.strided_out_set(level, kernel, stride, padding,
                                            int(cap))
        ids, coords, mask = books[key][:3]
        level = sparse.SparseLevel(None, ids, coords, mask, _out_shape(
            shape, _triple(kernel), _triple(stride), _triple(padding)))
        shape = level.shape
    return books


def encoder_spec(sparse_shape, caps, last_pad):
    """Book spec of BackBone8x's encoder geometry.

    :param caps: resolved per-level caps (conv2, conv3, conv4, conv_out)
    :return: ordered op list of ('subm', key) |
        ('spconv', key, kernel, stride, padding, cap)
    """
    return [
        ('subm', 'subm1'),
        ('spconv', 'spconv2', (3, 3, 3), (2, 2, 2), (1, 1, 1), caps[0]),
        ('subm', 'subm2'),
        ('spconv', 'spconv3', (3, 3, 3), (2, 2, 2), (1, 1, 1), caps[1]),
        ('subm', 'subm3'),
        ('spconv', 'spconv4', (3, 3, 3), (2, 2, 2), (0, 1, 1), caps[2]),
        ('subm', 'subm4'),
        ('spconv', 'convout', (3, 1, 1), (2, 1, 1), _triple(last_pad),
         caps[3]),
    ]


def build_books_batch_np(coords_b, mask_b, sparse_shape, spec):
    """`build_books_batch` by the numpy builders, sample by sample."""
    m = np.asarray(mask_b).astype(bool)
    per = [_books_sample_np(np.asarray(coords_b)[i], m[i], sparse_shape, spec)
           for i in range(m.shape[0])]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def build_books_batch(coords_b, mask_b, sparse_shape, spec):
    """Every book of `spec` for a batch, in the wire format ('hb_*' arrays):
    by the native builders where the masks are prefixes, else by
    `build_books_batch_np`.  The native library is required: where it does
    not build, this raises.

    :param coords_b: (B, V, 3) int32 ZYX sorted by linear id, -1 padded
    :param mask_b: (B, V) bool live voxels
    """
    coords_b, mask_b = np.asarray(coords_b), np.asarray(mask_b)
    m = mask_b.astype(bool)
    lib = native_lib()
    if lib is None:
        raise RuntimeError('the native host book builder did not build: %s'
                           % native_error())
    if bool(np.all(m[:, :-1] >= m[:, 1:])):
        return _build_books_batch_native(lib, coords_b, mask_b, sparse_shape,
                                         spec)
    return build_books_batch_np(coords_b, m, sparse_shape, spec)


def wire_arrays(flat, spec):
    """The spec's wire arrays in a fixed order, as (name, array) pairs;
    uint16 rows travel as int16 and the uint32 masks as int32 (K <= 27, so
    bit 31 is never set)."""
    out = []
    for op in spec:
        key = op[1]
        fields = _SUBM_FIELDS if op[0] == 'subm' else _STRIDED_FIELDS
        for f in fields:
            a = np.asarray(flat['hb_%s_%s' % (key, f)])
            if a.dtype == np.uint16:
                a = a.view(np.int16)
            elif a.dtype == np.uint32:
                a = a.view(np.int32)
            elif a.dtype == bool:
                a = a.view(np.uint8)
            out.append(('%s_%s' % (key, f), np.ascontiguousarray(a)))
    return out


_TORCH = {np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
          np.dtype(np.uint8): torch.uint8,
          np.dtype(np.float32): torch.float32}


def decode_rules(rows, fnd, n_in):
    """Wire rows (.., K) int16 (uint16 bits) and found masks (..) int32 ->
    (.., K) int32 rules with misses routed to `n_in`.  Rows are per sample,
    so they are widened to int32 before anything adds to them."""
    k = rows.shape[-1]
    taps = torch.arange(k, dtype=torch.int32, device=rows.device)
    found = ((fnd[..., None] >> taps) & 1) > 0
    return torch.where(found, rows.to(torch.int32) & 0xFFFF, n_in)


def upload(arrays, device):
    """(name, numpy array) pairs -> {name: device tensor} in ONE host to
    device copy (each array 16-byte aligned in one staging buffer)."""
    offsets, total = [], 0
    for _, a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    host = np.zeros(total, np.uint8)
    for (_, a), off in zip(arrays, offsets):
        host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(host).to(device)
    return {name: dev[off:off + a.nbytes].view(_TORCH[a.dtype]).view(a.shape)
            for (name, a), off in zip(arrays, offsets)}


def decode_books(t, spec, input_cap):
    """Uploaded wire tensors (`upload(wire_arrays(..))`) -> decoded books:
    {key: rules} for subm books and {key: (ids, coords, mask, dropped,
    rules)} for strided books: ids (B, O) int32, coords (B, O, 3) int32,
    mask (B, O) bool, dropped (B,) int32, rules (B, O, K) int32."""
    books, n_in = {}, int(input_cap)
    for op in spec:
        key = op[1]
        if op[0] == 'subm':
            books[key] = decode_rules(t[key + '_rows'], t[key + '_fnd'], n_in)
            continue
        books[key] = (t[key + '_ids'], t[key + '_crd'],
                      t[key + '_msk'].view(torch.bool), t[key + '_drp'],
                      decode_rules(t[key + '_rows'], t[key + '_fnd'], n_in))
        n_in = int(op[5])
    return books


def upload_books(flat, spec, input_cap, device):
    """A batch's `hb_*` books (numpy, wire format) -> decoded device books
    (`decode_books`), in one copy.

    :param spec: `encoder_spec` op list the books were built for
    :param input_cap: voxel cap of the input level (its zero row index)
    """
    return decode_books(upload(wire_arrays(flat, spec), device), spec,
                        input_cap)


def make_batch_transform(model, training):
    """The loader's `batch_transform` that adds a model's host books to a
    collated batch (`pcdet_tpu.ops.host_books.make_batch_transform`): the
    `hb_*` wire arrays at the model's train or eval caps
    (`model.host_book_spec(cap, training)`), by the native builders.  None
    for a model without sparse convs (PointPillar).  It runs in the
    loader's producer thread, beside the device step.  None also under
    cfg.TORCH_VOXEL_GENERATOR, whose books come from the device's voxels
    (`train.trainer.Trainer.upload`, `detect.SparseDetector.upload`), and
    under PCDET_HOST_BOOKS=0 (`use_host_books`), whose books are built on
    the device."""
    if (not hasattr(model, 'host_book_spec') or not use_host_books()
            or model.cfg.get('TORCH_VOXEL_GENERATOR', False)):
        return None
    sparse_shape, spec = model.sparse_shape, []

    def transform(batch):
        # a loader's batches all have its mode's voxel cap
        if not spec:
            spec.append(model.host_book_spec(batch['coordinates'].shape[1],
                                             training))
        batch.update(build_books_batch(batch['coordinates'],
                                       batch['voxel_mask'], sparse_shape,
                                       spec[0]))
        return batch

    return transform


# a loader batch's arrays that go to the device, in this order
LOADER_KEYS = ('voxels', 'num_points', 'coordinates', 'voxel_mask',
               'voxel_overflow', 'gt_boxes', 'box_cls_labels',
               'box_reg_targets', 'seg_labels', 'part_labels', 'points',
               'point_mask', 'bev')
# the loader's voxelizer outputs, which cfg.TORCH_VOXEL_GENERATOR replaces
VOXEL_KEYS = ('voxels', 'num_points', 'coordinates', 'voxel_mask',
              'voxel_overflow')


def upload_loader_batch(batch, device, model, train):
    """A collated loader batch (numpy, `datasets.collate_batch`) -> the
    model's batch on `device`, in ONE copy: voxels, num_points (as
    `num_points_per_voxel`), coordinates, voxel_mask, voxel_overflow and,
    where the batch has them, gt_boxes, the anchor targets, Part-A²'s
    per-voxel seg_labels / part_labels, the fork's points / point_mask
    (B, P) and BEV masks `bev`; for a model
    with sparse convs also its books at the train or eval caps, decoded
    into `books`: the batch's `hb_*` books, which the loader's
    `make_batch_transform` adds, or, for a batch without them under
    PCDET_HOST_BOOKS=0, books built on the device from the uploaded coords
    (`model.device_books`; without them otherwise it raises).  Under
    cfg.TORCH_VOXEL_GENERATOR the loader's voxels and books stay on the
    host: the points are voxelized again on the device (`experiments.
    between_dataloading_and_feedforward`)."""
    revoxelize = model.cfg.get('TORCH_VOXEL_GENERATOR', False)
    keys = tuple(k for k in LOADER_KEYS
                 if not (revoxelize and k in VOXEL_KEYS))
    spec, on_device = None, False
    if hasattr(model, 'host_book_spec') and not revoxelize:
        on_device = not any(k.startswith('hb_') for k in batch)
        if on_device and use_host_books():
            raise ValueError(
                'a batch for a model with sparse convs needs its hb_* '
                'books: set the loader\'s batch_transform to '
                'host_books.make_batch_transform(model, training), or '
                'build the books on the device under PCDET_HOST_BOOKS=0')
        if not on_device:
            spec = model.host_book_spec(batch['coordinates'].shape[1], train)
    arrays, bools = [], []
    for key in keys:
        if key in batch:
            a = np.ascontiguousarray(batch[key])
            if a.dtype == bool:
                bools.append(key)
                a = a.view(np.uint8)
            arrays.append((key, a))
    if spec is not None:
        arrays += wire_arrays(batch, spec)
    t = upload(arrays, device)
    out = {key: t[key] for key in keys if key in t}
    for key in bools:
        out[key] = out[key].view(torch.bool)
    if 'num_points' in out:
        out['num_points_per_voxel'] = out.pop('num_points')
    if spec is not None:
        out['books'] = decode_books(t, spec, batch['coordinates'].shape[1])
    elif on_device:
        out['books'] = model.device_books(out['coordinates'], train)
    return out
