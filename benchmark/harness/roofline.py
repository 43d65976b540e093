# Frozen copy of chip_smoke.py:377-381 (PEAK_BYTES_PER_S, PEAK_OPS_PER_S)
# and chip_smoke.py:422-446 (bound_ms, gather_work) at the commit that added
# this benchmark, with the peaks keyed by precision name and the work taken
# from the benchmark's own rule counts instead of the program's books.
"""The H100 SXM's published peaks and the least time of the work counted.

Peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM 3.35 TB/s;
989 TFLOP/s bf16 (f32 sums), 495 TF32, 67 float32 outside the tensor
cores.  A sparse conv launch needs 2 Cin Cout operations per found (live
output row, tap) pair and moves, each once, the distinct table rows it
reads, its index data (K int32 a live row), its weights and its output.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {'bfloat16': 989e12, 'tf32': 495e12, 'float32': 67e12}
ELEMENT_BYTES = {'bfloat16': 2, 'tf32': 4, 'float32': 4}


def bound_s(ops, nbytes, precision):
    """Least seconds the card could take: the larger of operations at the
    precision's peak and bytes at the HBM peak."""
    return max(ops / PEAK_OPS_PER_S[precision], nbytes / PEAK_BYTES_PER_S)


def gather_work(cin, cout, k, found, rows_read, n_live, precision):
    """(operations, bytes) of one gather-GEMM: `found` pairs, `rows_read`
    distinct table rows of `cin` channels, `n_live` output rows of `cout`
    f32 channels, each with its K int32 indices, and the K x cin x cout
    weights."""
    e = ELEMENT_BYTES[precision]
    ops = 2 * cin * cout * found
    nbytes = (rows_read * cin * e + n_live * k * 4 + k * cin * cout * e
              + n_live * cout * 4)
    return ops, nbytes


def dw_work(cin, cout, k, found, rows_read, n_live):
    """(operations, bytes) of one weight-gradient launch: the table rows
    read, the live rows' gradients and indices, and dW written (f32)."""
    ops = 2 * cin * cout * found
    nbytes = (rows_read * cin * 4 + n_live * (cout * 4 + k * 4)
              + k * cin * cout * 4)
    return ops, nbytes


def sparse_launches(work, train, forward_precision):
    """(least seconds, {precision: operations}) of the sparse convs of one
    batch from the benchmark's per-conv counts (`reference.sparse`): the
    forward at `forward_precision`; in training also each conv's feature
    gradient (over the transposed book: outputs read, inputs written; none
    for the first conv, whose input has no parameters behind it) on the
    FFMA core and its weight gradient, bounded at the TF32 peak (the dW
    kernels may run 3xTF32 on the tensor cores)."""
    least, ops = 0.0, {}

    def add(p, o, b):
        nonlocal least
        least += bound_s(o, b, p)
        ops[p] = ops.get(p, 0) + o

    for i, w in enumerate(work):
        o, b = gather_work(w['cin'], w['cout'], w['k'], w['found'],
                           w['rows_read'], w['n_out'], forward_precision)
        add(forward_precision, o, b)
        if not train:
            continue
        if i > 0:
            o, b = gather_work(w['cout'], w['cin'], w['k'], w['found'],
                               w['out_read'], w['n_in'], 'float32')
            add('float32', o, b)
        o, b = dw_work(w['cin'], w['cout'], w['k'], w['found'],
                       w['rows_read'], w['n_out'])
        add('tf32', o, b)
    return least, ops
