"""Rotated-rectangle intersection areas over a batched pair grid.

Two kernels compute this function by different methods:

- A, `pair_overlap_batched`, replaces the TPU kernel
  `pcdet_tpu.ops.pallas.rotated_overlap.pair_overlap_batched` (Green's
  theorem over clipped edges; `csrc/rotated_overlap.cu`).  NMS and the
  evaluation's recall run it; `pair_overlap` is its G = 1 case (A′).  It
  computes only the pairs `overlap_maybe_nonzero_plain` keeps (by clipping,
  or in closed form where a finite quad meets a one-point quad) and writes
  +0.0 for the rest, which is the plain version's area there bit for bit;
  `pair_overlap_batched_counted` also returns how many pairs it kept.
- A″, `pair_overlap_sorted_batched`, replaces
  `pcdet_tpu.ops.pallas.rotated_overlap.pair_overlap_sorted` (24 candidate
  vertices, dedup, an angular successor scan; `csrc/rotated_overlap_sorted.cu`).
  It is A's independent cross-check, as in the JAX package;
  `pair_overlap_sorted` is its G = 1 case.  It works only on each pair's
  accepted candidates; `sorted_work_plain` counts that work.

On a CUDA tensor each wrapper launches its hand-written kernel (built with
nvcc at first use) or raises; on a CPU tensor it computes its plain version
(`pair_overlap_batched_plain`, `pair_overlap_sorted_plain`).  There is no
fallback from the one to the other.

`LAUNCHES` (A) and `LAUNCHES_SORTED` (A″) count kernel launches, so a run
can show that its path went through the kernel.
"""
import ctypes
import functools

import torch

from . import cuda_build, rotated_iou

LAUNCHES = 0
LAUNCHES_SORTED = 0
_MAX_GRID_YZ = 65535
_ROWS_PER_BLOCK = 8         # the least kTileM of A
_ROWS_PER_BLOCK_SORTED = 4  # kRowsM of A″ (a block 32 columns x 4 rows)

# kernel A's cull (csrc/rotated_overlap.cu, whose header holds the argument
# that a pair it discards has area +0.0)
CULL_GAP = 2.0 ** -6          # delta: m between the two axis-aligned boxes
CULL_COORD_MAX = 256.0        # W: |x| and |y| of every corner at most this
CULL_MIN_EDGE2 = 2.0 ** -20   # tau: each squared edge length above this

# the Pallas kernel's constants (pcdet_tpu/ops/pallas/rotated_overlap.py)
EPS = 1e-8
INSIDE_EPS = 1e-6
DUP_TOL = 1e-6
BIG = 1e9
N_CAND = 24


def _load(name, source, entry, pointers):
    lib = cuda_build.load_library(name, (source,))
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * pointers + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pcdet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pcdet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def build():
    """Build (or reuse) and load kernel A's library; returns it."""
    return _load('rotated_overlap', 'rotated_overlap.cu',
                 'pcdet_rotated_overlap_batched', 4)


@functools.cache
def build_sorted():
    """Build (or reuse) and load kernel A″'s library; returns it."""
    return _load('rotated_overlap_sorted', 'rotated_overlap_sorted.cu',
                 'pcdet_rotated_overlap_sorted_batched', 3)


def sorted_blocks_per_sm():
    """Blocks of kernel A″ one SM of the current CUDA device holds at
    once."""
    lib = build_sorted()
    n = lib.pcdet_rotated_overlap_sorted_blocks_per_sm()
    if n <= 0:
        raise RuntimeError('no block of kernel A″ fits an SM: %s' % (
            lib.pcdet_cuda_error_string(-n).decode() if n else 'none'))
    return n


def pair_overlap_batched_plain(corners_a, corners_b):
    """(G, M, 4, 2) x (G, N, 4, 2) -> (G, M, N) areas, in plain PyTorch."""
    return rotated_iou.quad_intersection_area(corners_a[:, :, None],
                                              corners_b[:, None])


def cull_boxes_plain(corners):
    """(..., 4, 2) corners -> (..., 4) cull boxes [min x, max x, min y,
    max y]: a quad's axis-aligned bounding box when it is cullable (every
    |x|, |y| <= CULL_COORD_MAX, every squared edge length > CULL_MIN_EDGE2,
    every corner a left turn with sin(angle) >= 1/2), else [-inf, inf,
    -inf, inf], which no comparison separates.  Kernel A's `cull_box`, op
    for op."""
    x, y = corners[..., 0], corners[..., 1]
    ex = torch.roll(x, -1, -1) - x          # edge k: corner k -> k + 1
    ey = torch.roll(y, -1, -1) - y
    l2 = ex * ex + ey * ey
    pex, pey, pl2 = (torch.roll(v, 1, -1) for v in (ex, ey, l2))  # edge k-1
    cross = pex * ey - pey * ex
    ok = ((x.abs() <= CULL_COORD_MAX) & (y.abs() <= CULL_COORD_MAX)
          & (l2 > CULL_MIN_EDGE2) & (cross > 0)
          & (cross * cross > 0.25 * pl2 * l2)).all(-1)
    box = torch.stack([x.amin(-1), x.amax(-1), y.amin(-1), y.amax(-1)], -1)
    inf = torch.tensor([-torch.inf, torch.inf, -torch.inf, torch.inf],
                       dtype=box.dtype, device=box.device)
    return torch.where(ok[..., None], box, inf)


def overlap_maybe_nonzero_plain(corners_a, corners_b):
    """(G, M, 4, 2) x (G, N, 4, 2) -> (G, M, N) bool: False only where
    kernel A culls the pair, which is only where both quads are cullable
    and their boxes lie more than CULL_GAP apart on x or on y, so where the
    plain version's area is +0.0.  A degenerate quad (one point, a
    zero-length side), a clockwise one or a NaN keeps every pair it is in.
    Evaluated as the kernel does, so its sum is the kernel's count of pairs
    kept."""
    ba = cull_boxes_plain(corners_a)[:, :, None]
    bb = cull_boxes_plain(corners_b)[:, None]
    apart = ((ba[..., 1] + CULL_GAP < bb[..., 0])
             | (bb[..., 1] + CULL_GAP < ba[..., 0])
             | (ba[..., 3] + CULL_GAP < bb[..., 2])
             | (bb[..., 3] + CULL_GAP < ba[..., 2]))
    return ~apart


def _cross(ox, oy, px, py, qx, qy):
    return (px - ox) * (qy - oy) - (qx - ox) * (py - oy)


def _inside(qx, qy, px, py):
    ok = None
    for e in range(4):
        c = _cross(qx[e], qy[e], qx[(e + 1) % 4], qy[(e + 1) % 4], px, py)
        cond = c >= -INSIDE_EPS
        ok = cond if ok is None else (ok & cond)
    return ok


def _diamond_angle(dx, dy):
    """Monotonic-in-angle pseudo-angle in [0, 4), no transcendentals."""
    adx = torch.abs(dx)
    ady = torch.abs(dy)
    denom = torch.clamp(adx + ady, min=EPS)
    q1 = dy / denom
    q2 = 1.0 + adx / denom
    q3 = 2.0 + ady / denom
    q4 = 3.0 + dx / denom
    pos_x = dx >= 0
    pos_y = dy >= 0
    return torch.where(pos_x & pos_y, q1,
                       torch.where(~pos_x & pos_y, q2,
                                   torch.where(~pos_x & ~pos_y, q3, q4)))


def _sorted_plain(corners_a, corners_b, work=False):
    """(G, M, N) f32 areas by kernel A″'s method over 24 slots; with
    `work`, (areas, the counts of `sorted_work_plain`)."""
    shape = torch.broadcast_shapes(corners_a[:, :, None].shape,
                                   corners_b[:, None].shape)[:-2]
    ca = corners_a[:, :, None].expand(*shape, 4, 2)
    cb = corners_b[:, None].expand(*shape, 4, 2)
    ax = [ca[..., k, 0] for k in range(4)]
    ay = [ca[..., k, 1] for k in range(4)]
    bx = [cb[..., k, 0] for k in range(4)]
    by = [cb[..., k, 1] for k in range(4)]

    # 1. candidates: A's corners inside B, B's inside A, 16 edge crossings
    px, py, va = list(ax) + list(bx), list(ay) + list(by), []
    denom_ok = t_ok = 0
    va += [_inside(bx, by, ax[k], ay[k]) for k in range(4)]
    va += [_inside(ax, ay, bx[k], by[k]) for k in range(4)]
    for i in range(4):
        i1 = (i + 1) % 4
        rx, ry = ax[i1] - ax[i], ay[i1] - ay[i]
        for j in range(4):
            j1 = (j + 1) % 4
            sx, sy = bx[j1] - bx[j], by[j1] - by[j]
            denom = rx * sy - ry * sx
            nonpar = torch.abs(denom) > EPS
            safe = torch.where(nonpar, denom, 1.0)
            qpx, qpy = bx[j] - ax[i], by[j] - ay[i]
            t = (qpx * sy - qpy * sx) / safe
            u = (qpx * ry - qpy * rx) / safe
            px.append(ax[i] + t * rx)
            py.append(ay[i] + t * ry)
            t_in = nonpar & (t >= 0) & (t <= 1)
            va.append(t_in & (u >= 0) & (u <= 1))
            if work:
                denom_ok = denom_ok + nonpar.long()
                t_ok = t_ok + t_in.long()
    px = torch.stack(px, -1)                             # (..., 24)
    py = torch.stack(py, -1)
    va = torch.stack(va, -1)
    crossings = va[..., 8:].sum(-1) if work else None
    dedup_tests = 0

    # 2. sequential dedup: j against the candidates still valid below it
    for j in range(1, N_CAND):
        same = (va[..., :j]
                & (torch.abs(px[..., :j] - px[..., j:j + 1]) < DUP_TOL)
                & (torch.abs(py[..., :j] - py[..., j:j + 1]) < DUP_TOL))
        if work:        # the kernel tests j against its list up to a match
            listed = va[..., :j].long().cumsum(-1)
            first = same.long().argmax(-1, keepdim=True)
            tests = torch.where(same.any(-1),
                                listed.gather(-1, first)[..., 0],
                                listed[..., -1])
            dedup_tests = dedup_tests + torch.where(va[..., j], tests, 0)
        va[..., j] &= ~same.any(-1)

    # 3. centroid (sums over slots in order) and pseudo-angles
    count = torch.zeros_like(px[..., 0])
    sx = torch.zeros_like(count)
    sy = torch.zeros_like(count)
    for k in range(N_CAND):
        count = count + torch.where(va[..., k], 1.0, 0.0)
        sx = sx + torch.where(va[..., k], px[..., k], 0.0)
        sy = sy + torch.where(va[..., k], py[..., k], 0.0)
    denom_c = torch.clamp(count, min=1.0)
    cx, cy = sx / denom_c, sy / denom_c
    ang = torch.where(va, _diamond_angle(px - cx[..., None],
                                         py - cy[..., None]), BIG)

    # 4. successor of each i by the least positive gap, j ascending
    best = torch.full_like(px, BIG)
    nx, ny = px.clone(), py.clone()
    for j in range(N_CAND):
        gap = ang[..., j:j + 1] - ang
        gap = torch.where(gap <= 0.0, gap + 4.0, gap)
        ok = va[..., j:j + 1] & va
        ok[..., j] = False
        gap = torch.where(ok, gap, BIG)
        take = gap < best
        best = torch.where(take, gap, best)
        nx = torch.where(take, px[..., j:j + 1], nx)
        ny = torch.where(take, py[..., j:j + 1], ny)
    terms = px * ny - nx * py
    terms = torch.where(va & (best < BIG / 2), terms, 0.0)
    area2 = torch.zeros_like(count)
    for k in range(N_CAND):
        area2 = area2 + terms[..., k]
    area = torch.where(count >= 3.0, 0.5 * torch.abs(area2), 0.0)
    if not work:
        return area
    return area, {'length': count.long(), 'denom_ok': denom_ok,
                  't_ok': t_ok, 'crossings': crossings,
                  'dedup_tests': dedup_tests}


def pair_overlap_sorted_plain(corners_a, corners_b):
    """(G, M, 4, 2) x (G, N, 4, 2) -> (G, M, N) areas by kernel A″'s method,
    in plain PyTorch over a candidate axis of 24, step by step as the
    Pallas `_overlap_kernel` runs: the candidates in slot order, the
    sequential dedup, the centroid and the shoelace summed over slots in
    order, the successor scan with j ascending and a strict `<`."""
    return _sorted_plain(corners_a, corners_b)


def sorted_work_plain(corners_a, corners_b):
    """(G, M, 4, 2) x (G, N, 4, 2) -> {name: (G, M, N) int64}, what sets
    each pair's work in kernel A″: `length`, its accepted list's length (the
    candidates left valid after the dedup, 0 to 24); of its 16 edge
    crossings, `denom_ok` those whose denominator passes (t is computed),
    `t_ok` those whose t passes too (u is computed) and `crossings` the
    valid ones (the point is computed); `dedup_tests`, the tests of a valid
    candidate against the list accepted before it, up to a match."""
    return _sorted_plain(corners_a, corners_b, work=True)[1]


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


def _launch(build_lib, entry, rows_per_block, corners_a, corners_b,
            extra=()):
    """One launch of a kernel on checked CUDA operands -> (G, M, N);
    `extra` are pointers passed after the output's."""
    if corners_a.device.type != 'cuda':
        raise ValueError('unsupported device %s' % corners_a.device)
    g, m, n = corners_a.shape[0], corners_a.shape[1], corners_b.shape[1]
    if g > _MAX_GRID_YZ or -(-m // rows_per_block) > _MAX_GRID_YZ:
        raise ValueError('grid too large: G=%d M=%d' % (g, m))
    if n >= 2 ** 31:
        raise ValueError('N=%d does not fit the kernel\'s int' % n)
    lib = build_lib()
    out = torch.empty((g, m, n), dtype=torch.float32, device=corners_a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(corners_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(corners_a.data_ptr(), corners_b.data_ptr(),
                                 out.data_ptr(), *extra, g, m, n, stream)
    cuda_build.check(lib, rc)
    return out


def _overlap_a(corners_a, corners_b, survivors):
    global LAUNCHES
    out = _launch(build, 'pcdet_rotated_overlap_batched', _ROWS_PER_BLOCK,
                  corners_a, corners_b, (survivors,))
    LAUNCHES += int(out.numel() > 0)
    return out


def pair_overlap_batched(corners_a, corners_b):
    """(G, M, 4, 2) x (G, N, 4, 2) f32 CCW corners -> (G, M, N) f32
    intersection areas; independent pair problems per group (kernel A)."""
    _check(corners_a, corners_b)
    if corners_a.device.type == 'cpu':
        return pair_overlap_batched_plain(corners_a, corners_b)
    return _overlap_a(corners_a, corners_b, None)


def pair_overlap_batched_counted(corners_a, corners_b):
    """`pair_overlap_batched` -> (areas, count): `count` is a 0-d int32
    tensor on the operands' device, the pairs kernel A did not cull (on the
    CPU, the pairs `overlap_maybe_nonzero_plain` keeps)."""
    _check(corners_a, corners_b)
    if corners_a.device.type == 'cpu':
        return (pair_overlap_batched_plain(corners_a, corners_b),
                overlap_maybe_nonzero_plain(corners_a, corners_b).sum(
                    dtype=torch.int32))
    count = torch.zeros((), dtype=torch.int32, device=corners_a.device)
    return _overlap_a(corners_a, corners_b, count.data_ptr()), count


def pair_overlap(corners_a, corners_b):
    """(M, 4, 2) x (N, 4, 2) -> (M, N): the G = 1 case of kernel A."""
    return pair_overlap_batched(corners_a[None], corners_b[None])[0]


def pair_overlap_sorted_batched(corners_a, corners_b):
    """(G, M, 4, 2) x (G, N, 4, 2) f32 CCW corners -> (G, M, N) f32
    intersection areas by kernel A″ (A's cross-check)."""
    global LAUNCHES_SORTED
    _check(corners_a, corners_b)
    if corners_a.device.type == 'cpu':
        return pair_overlap_sorted_plain(corners_a, corners_b)
    out = _launch(build_sorted, 'pcdet_rotated_overlap_sorted_batched',
                  _ROWS_PER_BLOCK_SORTED, corners_a, corners_b)
    LAUNCHES_SORTED += int(out.numel() > 0)
    return out


def pair_overlap_sorted(corners_a, corners_b):
    """(M, 4, 2) x (N, 4, 2) -> (M, N): the G = 1 case of kernel A″."""
    return pair_overlap_sorted_batched(corners_a[None], corners_b[None])[0]
