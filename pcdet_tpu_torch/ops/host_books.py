"""Host-built sparse-conv rulebooks, uploaded and decoded for the port.

The books are built by `pcdet_tpu.ops.host_books` (numpy, with its native
C++ builders through `pcdet_tpu.native`; neither imports jax) from the
voxelizer's sorted coords, in the compact wire format of `hb_*` arrays:
rows uint16 (B, V, K) per sample, the found taps as one uint32 bitmask per
output row, and for a strided conv its output set (ids, coords, mask) and
drop count.  `upload_books` moves a batch's books to the device in ONE
copy and decodes them there into the gather-GEMM's rules: (B, V_out, K)
int32, misses routed to the input level's zero row V_in.
"""
import numpy as np
import torch

from pcdet_tpu.ops import host_books as _books

encoder_spec = _books.encoder_spec
build_books_batch = _books.build_books_batch

_STRIDED_FIELDS = ('ids', 'crd', 'msk', 'drp', 'rows', 'fnd')
_ALIGN = 16


def wire_arrays(flat, spec):
    """The spec's wire arrays in a fixed order, as (name, array) pairs;
    uint16 rows travel as int16 and the uint32 masks as int32 (K <= 27, so
    bit 31 is never set)."""
    out = []
    for op in spec:
        key = op[1]
        fields = ('rows', 'fnd') if op[0] == 'subm' else _STRIDED_FIELDS
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
