"""Two builds of kernel A (rotated-rectangle overlap areas), or of kernel A″,
timed in turns on one GPU.

    python3 rotated_overlap_ab.py OLD_SOURCE
    python3 rotated_overlap_ab.py --sorted OLD_SOURCE

OLD_SOURCE is another version of `pcdet_tpu_torch/csrc/rotated_overlap.cu`
with the C entry point of the kernel before the cull,
`pcdet_rotated_overlap_batched(a, b, out, g, m, n, stream)`, for example
one taken from git (`git show REV:pcdet_tpu_torch/csrc/rotated_overlap.cu >
build/ab/old_rotated_overlap.cu`).  It is built with the port's nvcc flags
beside the library the port builds from the checkout.  On the NMS shape
(G=2, M=64, N=4096, `chip_smoke.py`'s boxes) and its first group (A′,
G = 1, the shape at which a B1 detect launches it), the real NMS rounds of a
PointPillar B2 detect (`pointpillar.yaml`, random weights from seed 0,
`conv_cls.bias` zeroed), a B8 recall grid (500 predictions x 128 GT a
sample, zero-padded rows in both), one of its groups (A′, G = 1), the same
NMS shape with degenerate quads (one-point rows, a zero-length side),
near misses placed just past and just inside the cull gap, the crafted
pairs and two ragged shapes, it checks that old and new are each bitwise
equal to the plain version, that two new launches agree and that the new
kernel's count of pairs kept (not culled) equals the plain predicate's, and times
old, new, new, old (device time, queued behind a spin kernel).  Prints the
new build's registers and spills.

With --sorted, OLD_SOURCE is another version of
`pcdet_tpu_torch/csrc/rotated_overlap_sorted.cu` (kernel A″) with the C
entry point `pcdet_rotated_overlap_sorted_batched(a, b, out, g, m, n,
stream)`, for example `git show 405b7ab:pcdet_tpu_torch/csrc/
rotated_overlap_sorted.cu > build/ab/old_rotated_overlap_sorted.cu`.  On
the B8 recall grid, one group of it, the NMS shape, the same shape with
degenerate quads and the crafted quads of `chip_smoke.sorted_crafted_quads`
it checks that old and new are each bitwise equal to the plain version and
that two new launches agree, and times old, new, new, old (device time,
queued behind a spin kernel), with the accepted lists' mean and largest
length.  Prints each build's registers and spills and the new build's
blocks per SM.

Exits nonzero when a check fails.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


ENTRY = 'pcdet_rotated_overlap_batched'
SORTED_ENTRY = 'pcdet_rotated_overlap_sorted_batched'


def build_source(src, name='old', entry=ENTRY, flags=()):
    """Build `src` with the port's nvcc flags (and `flags`) into
    lib<...>_<name>.so -> (library, ptxas report)."""
    from pcdet_tpu_torch.ops import cuda_build
    out = cuda_build.BUILD_DIR / ('librotated_overlap_ab_%s.so' % name)
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                           *flags, '-Xptxas', '-v', '-o', str(out), str(src)],
                          check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    getattr(lib, entry).argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    getattr(lib, entry).restype = ctypes.c_int
    return lib, proc.stderr


def call_lib(lib, ca, cb, entry=ENTRY):
    g, m, n = ca.shape[0], ca.shape[1], cb.shape[1]
    out = torch.empty((g, m, n), device=ca.device)
    rc = getattr(lib, entry)(
        ca.data_ptr(), cb.data_ptr(), out.data_ptr(), g, m, n,
        torch.cuda.current_stream().cuda_stream)
    cs.require(rc == 0, 'kernel launch failed: %d' % rc)
    return out


def corners5(boxes, dev):
    from pcdet_tpu_torch.ops import rotated_iou
    return rotated_iou.boxes5_to_corners(
        torch.as_tensor(boxes, device=dev)).contiguous()


def recall_grid(dev, seed=4):
    """(corners of 8 x 500 predictions, of 8 x 128 GT) of
    `chip_smoke.recall_grid_boxes7`, with its zero-padded rows."""
    from pcdet_tpu_torch.ops import rotated_iou
    return tuple(rotated_iou.boxes7_to_corners(torch.as_tensor(x, device=dev))
                 for x in cs.recall_grid_boxes7(np.random.RandomState(seed)))


def nms_rounds(dev):
    """The (block corners, all corners) of every NMS round of a
    PointPillar B2 detect (random weights, conv_cls's bias zeroed)."""
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    cfg = detect_mod.load_config()
    det = detect_mod.build_detector(cfg, dev, seed=0)
    with torch.no_grad():
        det.model.module.rpn_head.conv_cls.bias.zero_()
    pts, mask = detect_mod.make_scans(cfg, 2)
    rounds = []

    def capture(ca, cb):
        rounds.append((ca.clone(), cb))
        return ro.pair_overlap_batched_plain(ca, cb)

    with torch.inference_mode():
        ret = det.model.forward(det.voxelize(torch.as_tensor(pts, device=dev),
                                             torch.as_tensor(mask,
                                                             device=dev)))
        cs.run_nms(cs.candidates(det.model, ret, cfg.MODEL.TEST),
                   cfg.MODEL.TEST, capture)
    return rounds


def compare(old, ca, cb, iters=20):
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    new, count = ro.pair_overlap_batched_counted(ca, cb)
    again = ro.pair_overlap_batched(ca, cb)
    ref = call_lib(old, ca, cb)
    plain = ro.pair_overlap_batched_plain(ca, cb)
    kept = int(ro.overlap_maybe_nonzero_plain(ca, cb).sum())
    cs.sync()
    fns = {'old': lambda: call_lib(old, ca, cb),
           'new': lambda: ro.pair_overlap_batched(ca, cb)}
    turns = [cs.queued_ms(fns[v], iters)[0] for v in ('old', 'new', 'new',
                                                      'old')]
    return {'old_ms': (turns[0] + turns[3]) / 2,
            'new_ms': (turns[1] + turns[2]) / 2, 'turns': turns,
            'new_plain': bool(torch.equal(new, plain)),
            'old_plain': bool(torch.equal(ref, plain)),
            'repeat': bool(torch.equal(new, again)),
            'count': int(count), 'kept': kept, 'pairs': plain.numel(),
            'nonzero': int((plain != 0).sum())}


def print_builds(logs):
    for name, log in logs:
        print('[ab] %s build: %s' % (name, '; '.join(
            '%s %d registers, %d B spilled' % (r[0], r[2], r[3])
            for r in cs.ptxas_entries(log)) or 'ptxas report empty'))


def main_sorted(src):
    """--sorted: kernel A″, old / new -> exit code."""
    from pcdet_tpu_torch.ops import cuda_build
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    dev = torch.device('cuda')
    checkout = cuda_build.CSRC_DIR / 'rotated_overlap_sorted.cu'
    old, old_log = build_source(src, 'sorted_old', SORTED_ENTRY)
    # the port's library may be reused from an earlier build: the report
    # comes from a build of the same source with the same flags
    _, new_log = build_source(checkout, 'sorted_new', SORTED_ENTRY)
    ro.build_sorted()
    print_builds((('old', {'ptxas': old_log}), ('new', {'ptxas': new_log})))
    print('[ab] blocks of 128 threads an SM: new %d'
          % ro.sorted_blocks_per_sm())
    rows = cs.ptxas_entries({'ptxas': new_log})
    bad = [] if rows and not any(r[3] for r in rows) else ['new build spills']

    rng = np.random.RandomState(0)
    cb = corners5(cs.rand_boxes5(rng, (2, 4096)), dev)
    ca = cb[:, :64].contiguous()
    ra, rb = recall_grid(dev)
    quads = torch.as_tensor(np.concatenate(list(
        cs.sorted_crafted_quads().values())), device=dev)[None].contiguous()
    cases = {'B8 recall grid G=8 M=500 N=128': (ra, rb),
             'recall group G=1 M=500 N=128': (ra[:1].contiguous(),
                                              rb[:1].contiguous()),
             'NMS shape G=2 M=64 N=4096': (ca, cb),
             'NMS shape, degenerate quads': cs.degenerate_quads(ca, cb),
             'crafted quads G=1 M=N=%d' % quads.shape[1]: (quads, quads)}
    fns = {'old': lambda a, b: call_lib(old, a, b, SORTED_ENTRY),
           'new': ro.pair_overlap_sorted_batched}
    for tag, (a, b) in cases.items():
        plain = ro.pair_overlap_sorted_plain(a, b)
        got = {k: fn(a, b) for k, fn in fns.items()}
        again = ro.pair_overlap_sorted_batched(a, b)
        lengths = ro.sorted_work_plain(a, b)['length']
        cs.sync()
        same = {k: bool(torch.equal(v, plain)) for k, v in got.items()}
        repeat = bool(torch.equal(got['new'], again))
        turns = [cs.queued_ms(lambda: fns[v](a, b), 20)[0] for v in (
            'old', 'new', 'new', 'old')]
        ms = {'old': (turns[0] + turns[3]) / 2,
              'new': (turns[1] + turns[2]) / 2}
        print('[ab] A\'\' %-30s old %.4f new %.4f ms (old / new %.2fx; '
              'old, new, new, old %s); accepted list mean %.3f, max %d; '
              '== plain: old %s new %s; two new launches equal %s' % (
                  tag, ms['old'], ms['new'], ms['old'] / ms['new'],
                  ', '.join('%.4f' % x for x in turns),
                  lengths.double().mean().item(), int(lengths.max()),
                  same['old'], same['new'], repeat))
        if not (all(same.values()) and repeat):
            bad.append(tag)
    print('[ab] cases failing a check: %s' % bad)
    return 1 if bad else 0


def main(argv):
    sorted_mode = argv[1:2] == ['--sorted']
    if len(argv) != 2 + sorted_mode or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from pcdet_tpu_torch.ops import cuda_build
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    dev = torch.device('cuda')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    if sorted_mode:
        return main_sorted(Path(argv[2]))
    old, old_log = build_source(Path(argv[1]))
    ro.build()
    print_builds((('old', {'ptxas': old_log}),
                  ('new', cuda_build.BUILD_LOG['rotated_overlap'])))

    rng = np.random.RandomState(0)
    cb = corners5(cs.rand_boxes5(rng, (2, 4096)), dev)
    ca = cb[:, :64].contiguous()
    ra, rb = recall_grid(dev)
    cases = {'NMS shape G=2 M=64 N=4096': (ca, cb),
             "NMS shape, one group (A') G=1": (ca[:1].contiguous(),
                                               cb[:1].contiguous()),
             'B8 recall grid G=8 M=500 N=128': (ra, rb),
             "recall group (A') G=1 M=500 N=128": (ra[:1].contiguous(),
                                                   rb[:1].contiguous()),
             'NMS shape, degenerate quads': cs.degenerate_quads(ca, cb),
             'near misses G=1 M=64 N=4096': tuple(
                 torch.as_tensor(x, device=dev) for x in
                 cs.near_miss_pairs(np.random.RandomState(9))),
             'crafted 6 x 6': tuple(corners5(x, dev)[None] for x in
                                    cs.crafted_boxes5()),
             'ragged G=3 M=37 N=1000': (cb[:, :37].repeat(2, 1, 1, 1)[:3]
                                        .contiguous(),
                                        cb[:, :1000].repeat(2, 1, 1, 1)[:3]
                                        .contiguous()),
             'ragged G=1 M=5 N=7': (cb[:1, :5].contiguous(),
                                    cb[:1, 100:107].contiguous())}
    bad = []
    results = {}
    for tag, (a, b) in cases.items():
        results[tag] = r = compare(old, a, b)
        print('[ab] %-36s old %.4f new %.4f ms (%.2fx; old, new, new, old '
              '%s); pairs %d, kept %d (%.2f%%, plain predicate %d), '
              'nonzero %d; new == plain %s, old == plain %s, two new '
              'launches equal %s' % (
                  tag, r['old_ms'], r['new_ms'], r['old_ms'] / r['new_ms'],
                  ', '.join('%.4f' % x for x in r['turns']), r['pairs'],
                  r['count'], 100 * r['count'] / r['pairs'], r['kept'],
                  r['nonzero'], r['new_plain'], r['old_plain'], r['repeat']))
        if not (r['new_plain'] and r['old_plain'] and r['repeat']
                and r['count'] == r['kept']):
            bad.append(tag)

    rounds = nms_rounds(dev)
    sums = {'old': 0.0, 'new': 0.0}
    for i, (a, b) in enumerate(rounds):
        r = compare(old, a, b)
        for v in sums:
            sums[v] += r[v + '_ms']
        print('[ab] PointPillar B2 NMS round %d %s: old %.4f new %.4f ms; '
              'kept %d of %d (%.2f%%), nonzero %d; new == plain %s, old == '
              'plain %s, repeat %s, count == plain predicate %s' % (
                  i, tuple(a.shape[:2]) + (b.shape[1],), r['old_ms'],
                  r['new_ms'], r['count'], r['pairs'],
                  100 * r['count'] / r['pairs'], r['nonzero'], r['new_plain'],
                  r['old_plain'], r['repeat'], r['count'] == r['kept']))
        if not (r['new_plain'] and r['old_plain'] and r['repeat']
                and r['count'] == r['kept']):
            bad.append('NMS round %d' % i)
    print('[ab] A per PointPillar B2 detect batch (%d NMS rounds): old %.4f '
          'new %.4f ms' % (len(rounds), sums['old'], sums['new']))
    print('[ab] cases failing a check: %s' % bad)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
