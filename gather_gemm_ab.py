"""Two builds of the gather-GEMM kernels B and C, or of E and E′, timed in
turns on one GPU.

    python3 gather_gemm_ab.py OLD_SOURCE
    python3 gather_gemm_ab.py --xwin OLD_DIR

OLD_SOURCE is another version of `pcdet_tpu_torch/csrc/gather_gemm.cu`
with the same C entry point (`pcdet_gather_gemm`) and the headers it
includes beside it, for example from git:

    mkdir -p build/ab/old && for f in gather_gemm.cu gather_ptx.cuh; do
      git show REV:pcdet_tpu_torch/csrc/$f > build/ab/old/$f; done

(a revision whose gather_gemm.cu includes no header needs only that file).
It is built with the port's nvcc flags beside the library the port builds
from the checkout.  At every launch shape of SECOND's main path at B2 (the
11 kw=3 convs and conv_out: the forward in bf16 on the eval books, C; the
forward and the feature gradient in f32 on the train books, B; random
tables and weights from a seed) it times old, new, new, old (device time,
queued behind a spin kernel), checks that the new output equals the old
one bit for bit (B and C) and that two new launches agree, and prints each
error against the plain version, the share of (tile, tap) pairs the new
kernels skip, and the sums per train step (12 forward and 11
feature-gradient launches of B) and per detect batch (12 launches of C).
Exits nonzero when an output differs from the old build's.

With --xwin, OLD_DIR holds another version of `gather_gemm_xwin.cu` (entry
`pcdet_gather_gemm_xwin`) and the headers it includes:

    mkdir -p build/ab/xwin && for f in gather_gemm_xwin.cu \
        gather_common.cuh gather_ptx.cuh; do
      git show REV:pcdet_tpu_torch/csrc/$f > build/ab/xwin/$f; done

(files a revision lacks are skipped).  At the 11 kw=3 convs' launch shapes
at B2 (the forward in bf16 on the eval books, the forward and the feature
gradient in f32 on the train books, S = 256) it times E and E′ old, new,
new, old, and kernel B or C on the same book as rules; checks that new f32
equals old f32 and kernel B, that new bf16 equals kernel C, that two new
launches agree and that E′'s tally equals the segment descriptors' count;
and prints the sums per direction beside B's and C's.  Exits nonzero when
a check fails.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs


def build_old(src, name='gather_gemm_ab_old'):
    from pcdet_tpu_torch.ops import cuda_build
    out = cuda_build.BUILD_DIR / ('lib%s.so' % name)
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-I',
                           str(src.parent), '-o', str(out), str(src)],
                          capture_output=True, text=True)
    cs.require(proc.returncode == 0, 'nvcc failed for %s:\n%s' % (
        src, proc.stderr))
    lib = ctypes.CDLL(str(out))
    if hasattr(lib, 'pcdet_gather_gemm_xwin'):
        lib.pcdet_gather_gemm_xwin.argtypes = [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.pcdet_gather_gemm_xwin.restype = ctypes.c_int
    else:
        lib.pcdet_gather_gemm.argtypes = [ctypes.c_int] \
            + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.pcdet_gather_gemm.restype = ctypes.c_int
    return lib


def call_old(lib, table, rules, w, live):
    b, v_out, k = rules.shape
    out = torch.empty((b, v_out, w.shape[2]), device=table.device)
    rc = lib.pcdet_gather_gemm(
        int(table.dtype == torch.bfloat16), table.data_ptr(), rules.data_ptr(),
        w.data_ptr(), live.data_ptr(), out.data_ptr(), b, table.shape[1],
        v_out, k, table.shape[2], w.shape[2],
        torch.cuda.current_stream().cuda_stream)
    cs.require(rc == 0, 'old kernel launch failed: %d' % rc)
    return out


def books(cfg, dev):
    """(eval books, train books) of SECOND at B2, as `chip_smoke`'s X
    phases build them."""
    from pcdet_tpu_torch.ops import sparse
    from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans
    pts_np, mask_np, gt_np = make_train_scans(cfg, 2, ring_keep=0.35)
    pts = torch.as_tensor(pts_np, device=dev)
    mask = torch.as_tensor(mask_np, device=dev)
    det = cs.second_detector(cfg, dev, sparse.ROWS)
    with torch.inference_mode():
        vox = det.voxelize(pts, mask)
        eval_books = cs.level_books(
            det.books(vox), det.model.host_book_spec(det.max_voxels),
            det.max_voxels, vox['voxel_mask'])
    trainer = build_trainer(cfg, dev, seed=0, loads=sparse.ROWS)
    batch = trainer.make_batch(pts, mask, gt_np)
    train_books = cs.level_books(
        batch['books'], trainer.model.host_book_spec(trainer.max_voxels,
                                                     train=True),
        trainer.max_voxels, batch['voxel_mask'])
    return eval_books, train_books


def compare(old, case, cin, cout, dtype, gen):
    """One launch shape: {'old_ms', 'new_ms', 'turns', 'same', 'repeat',
    'err_new', 'err_old', 'skip', 'shape'}."""
    from pcdet_tpu_torch.ops import gather_gemm as gg
    rules, n_in, _, out_mask = case
    b, v_out, k = rules.shape
    live = out_mask.sum(1, dtype=torch.int32)
    table = cs.rand_table(gen, case, cin, rules.device).to(dtype)
    w = ((torch.rand((k, cin, cout), generator=gen) * 2 - 1)
         / (k * cin) ** 0.5).to(rules.device).to(dtype)
    new = gg.gather_gemm(table, rules, w, live)
    again = gg.gather_gemm(table, rules, w, live)
    ref = call_old(old, table, rules, w, live)
    plain = gg.gather_gemm_plain(table, rules, w, live)
    cs.sync()
    scale = plain.abs().max().item()
    fns = {'old': lambda: call_old(old, table, rules, w, live),
           'new': lambda: gg.gather_gemm(table, rules, w, live)}
    turns = [cs.device_ms(fns[v], 20) for v in ('old', 'new', 'new', 'old')]
    tile = gg.tile_rows(dtype, cin, cout)
    return {'old_ms': (turns[0] + turns[3]) / 2,
            'new_ms': (turns[1] + turns[2]) / 2, 'turns': turns,
            'same': bool(torch.equal(new, ref)),
            'repeat': bool(torch.equal(new, again)),
            'err_new': (new - plain).abs().max().item() / scale,
            'err_old': (ref - plain).abs().max().item() / scale,
            'skip': cs.skipped_share(rules, n_in, live, tile),
            'shape': (b, v_out, k, tile, live.tolist())}


def main(argv):
    xwin = len(argv) == 3 and argv[1] == '--xwin'
    if not (len(argv) == 2 or xwin) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.ops import gather_gemm as gg
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    if xwin:
        return main_xwin(Path(argv[2]))
    old = build_old(Path(argv[1]))
    gg.build()
    eval_books, train_books = books(
        detect_mod.load_config(detect_mod.SECOND_CFG), dev)
    gen = torch.Generator(device='cpu').manual_seed(7)
    cache, sums = {}, {}
    for conv, key, cin, cout in cs.KW3_CONVS + (('conv_out', 'convout', 64,
                                                 128),):
        subm = key.startswith('subm')
        jobs = [('fwd bf16', eval_books[key], cin, cout, torch.bfloat16),
                ('fwd f32', train_books[key], cin, cout, torch.float32)]
        if conv != 'conv_input':             # no feature gradient
            jobs.append(('dgrad f32', cs.bwd_book(train_books[key], subm),
                         cout, cin, torch.float32))
        for kind, case, ci, co, dtype in jobs:
            if (kind, key, ci, co) not in cache:
                cache[(kind, key, ci, co)] = compare(old, case, ci, co, dtype,
                                                     gen)
            r = cache[(kind, key, ci, co)]
            print('[ab] %-9s %-10s %-8s %3d -> %-3d (B, V_out, K, tile, live) '
                  '%s: old %.4f new %.4f ms (%.2fx; old, new, new, old %s); '
                  'new == old %s, two new launches equal %s; max error / max '
                  '|plain| new %.2e old %.2e; (tile, tap) pairs skipped '
                  '%.1f%%' % (kind, conv, key, ci, co, r['shape'],
                              r['old_ms'], r['new_ms'],
                              r['old_ms'] / r['new_ms'], ', '.join(
                                  '%.4f' % x for x in r['turns']), r['same'],
                              r['repeat'], r['err_new'], r['err_old'],
                              100 * r['skip']))
            for v in ('old', 'new'):
                sums[(kind, v)] = sums.get((kind, v), 0.0) + r[v + '_ms']
    for v in ('old', 'new'):
        print('[ab] %s: B per train step (12 forward + 11 feature gradient) '
              '%.4f ms; C per detect batch (12) %.4f ms' % (
                  v, sums[('fwd f32', v)] + sums[('dgrad f32', v)],
                  sums[('fwd bf16', v)]))
    bad = [k for k, r in cache.items() if not (r['same'] and r['repeat'])]
    print('[ab] shapes where the new B / C differs from the old or from a '
          'second launch: %s' % bad)
    return 1 if bad else 0


def call_old_xwin(lib, seg, table, base, sel, w, live, tally):
    b, v_out, groups = base.shape
    out = torch.empty((b, v_out, w.shape[2]), device=table.device)
    rc = lib.pcdet_gather_gemm_xwin(
        int(seg), int(table.dtype == torch.bfloat16), table.data_ptr(),
        base.data_ptr(), sel.data_ptr(), w.data_ptr(), live.data_ptr(),
        out.data_ptr(), tally.data_ptr(), b, table.shape[1], v_out, groups,
        table.shape[2], w.shape[2], 256,
        torch.cuda.current_stream().cuda_stream)
    cs.require(rc == 0, 'old E launch failed: %d' % rc)
    return out


def compare_xwin(old, case, cin, cout, dtype, gen):
    """One launch shape: B or C (`rows`) and E, E′ old and new, timed in
    turns, and their bit checks."""
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    rules, n_in, _, out_mask = case
    live = out_mask.sum(1, dtype=torch.int32)
    base, sel, clamped = sparse.xwin_selectors(rules, n_in)
    cs.require(int(clamped) == 0, 'a tap outside its window')
    table = cs.rand_table(gen, case, cin, rules.device).to(dtype)
    k = rules.shape[2]
    w = ((torch.rand((k, cin, cout), generator=gen) * 2 - 1)
         / (k * cin) ** 0.5).to(rules.device).to(dtype)
    scratch = torch.zeros(2, dtype=torch.int64, device=rules.device)
    rows = gg.gather_gemm(table, rules, w, live)
    r = {'rows_ms': cs.device_ms(lambda: gg.gather_gemm(table, rules, w,
                                                         live), 20),
         'shape': (tuple(base.shape), live.tolist())}
    for variant in ('xwin', 'seg'):
        seg = variant == 'seg'
        fns = {'new': (lambda: gx.gather_gemm_seg(table, base, sel, w, live))
               if seg else
               (lambda: gx.gather_gemm_xwin(table, base, sel, w, live)),
               'old': lambda: call_old_xwin(old, seg, table, base, sel, w,
                                            live, scratch)}
        gx.reset_seg_tiles()
        new = fns['new']()
        tiles = gx.seg_tiles()
        again, ref = fns['new'](), fns['old']()
        cs.sync()
        want = cs.expected_tiles(base, sel, live, gx.SEG_S) if seg else (0,
                                                                          0)
        turns = [cs.device_ms(fns[v], 20) for v in ('old', 'new', 'new',
                                                    'old')]
        r[variant] = {
            'old_ms': (turns[0] + turns[3]) / 2,
            'new_ms': (turns[1] + turns[2]) / 2, 'turns': turns,
            'rows': bool(torch.equal(new, rows)),
            'old': bool(torch.equal(new, ref)),
            'repeat': bool(torch.equal(new, again)),
            'tiles': (tiles['segment'], tiles['window']),
            'tiles_ok': (tiles['segment'], tiles['window']) == tuple(want)}
    return r


def main_xwin(old_dir):
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.ops import gather_xwin as gx
    dev = torch.device('cuda')
    old = build_old(old_dir / 'gather_gemm_xwin.cu', 'gather_gemm_xwin_ab_old')
    gx.build()
    eval_books, train_books = books(
        detect_mod.load_config(detect_mod.SECOND_CFG), dev)
    gen = torch.Generator(device='cpu').manual_seed(8)
    cache, sums, bad, slower = {}, {}, [], []
    for conv, key, cin, cout in cs.KW3_CONVS:
        jobs = [('fwd bf16', eval_books[key], cin, cout, torch.bfloat16),
                ('fwd f32', train_books[key], cin, cout, torch.float32)]
        if conv != 'conv_input':             # no feature gradient
            jobs.append(('dgrad f32', cs.bwd_book(train_books[key],
                                                  key.startswith('subm')),
                         cout, cin, torch.float32))
        for kind, case, ci, co, dtype in jobs:
            if (kind, key, ci, co) not in cache:
                cache[(kind, key, ci, co)] = compare_xwin(old, case, ci, co,
                                                          dtype, gen)
            r = cache[(kind, key, ci, co)]
            direction = 'detect' if kind == 'fwd bf16' else 'train'
            sums[(direction, 'rows')] = sums.get((direction, 'rows'),
                                                 0.0) + r['rows_ms']
            for variant in ('xwin', 'seg'):
                e = r[variant]
                name = "E'" if variant == 'seg' else 'E'
                ref = 'C' if dtype == torch.bfloat16 else 'B'
                print('[ab-xwin] %-9s %-10s %-8s %3d -> %-3d %-2s (B, V_out, '
                      'G) %s live %s: old %.4f new %.4f ms (%.2fx; old, new, '
                      'new, old %s), kernel %s %.4f ms; new == kernel %s %s, '
                      'new == old %s, two new launches equal %s%s' % (
                          kind, conv, key, ci, co, name, r['shape'][0],
                          r['shape'][1], e['old_ms'], e['new_ms'],
                          e['old_ms'] / e['new_ms'], ', '.join(
                              '%.4f' % x for x in e['turns']), ref,
                          r['rows_ms'], ref, e['rows'], e['old'],
                          e['repeat'], '; (tile, group)s by segment / window '
                          '%d / %d, descriptors agree %s' % (
                              e['tiles'] + (e['tiles_ok'],))
                          if variant == 'seg' else ''))
                ok = e['rows'] and e['repeat'] and e['tiles_ok'] and (
                    e['old'] or dtype == torch.bfloat16)
                if not ok:
                    bad.append((kind, conv, name))
                if e['new_ms'] > e['old_ms']:
                    slower.append((kind, conv, name))
                for v in ('old', 'new'):
                    sk = (direction, '%s %s' % (variant, v))
                    sums[sk] = sums.get(sk, 0.0) + e[v + '_ms']
    for direction, what in (('detect', 'detect forward bf16, kernel C'),
                            ('train', 'train forward + feature gradient '
                                      'f32, kernel B')):
        rows = sums[(direction, 'rows')]
        print('[ab-xwin] sums over the 11 kw=3 convs at B2, %s %.4f ms: %s'
              % (what, rows, ', '.join(
                  '%s %.4f (%+.1f%%)' % (k, sums[(direction, k)],
                                         100 * (sums[(direction, k)] / rows
                                                - 1))
                  for k in ('xwin old', 'xwin new', 'seg old', 'seg new'))))
    print('[ab-xwin] shapes where E / E\' is slower than the old build: %s'
          % slower)
    print('[ab-xwin] shapes failing a check (f32: == kernel B and == old; '
          'bf16: == kernel C; two launches equal; tally == descriptors): %s'
          % bad)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
