"""Two builds of the weight-gradient kernels D, D″ and D′, timed in turns
on one GPU, and the two compute cores of the checkout's build.

    python3 gather_dw_ab.py OLD_DIR

OLD_DIR holds another version of `pcdet_tpu_torch/csrc/gather_dw.cu` and
`gather_dw_xwin.cu` with the same C entry points and the headers they
include, for example from git:

    mkdir -p build/ab/old && for f in gather_dw.cu gather_dw_xwin.cu \
        gather_dw_common.cuh gather_common.cuh; do
      git show REV:pcdet_tpu_torch/csrc/$f > build/ab/old/$f; done

They are built with the port's nvcc flags beside the library the port
builds from the checkout, and the dW kernels are called with the chunking
the wrappers gave them: the checkout's (`ops/gather_dw.chunk_rows` on the
build's own residency) where the build exports its residency, as every
build since the pipelined core does, else the first version's
(`old_chunk_rows`).  With the same chunking, old and new sum in the same
order, and whether their outputs are bitwise equal is printed.  The
checkout's dW sources are also built with each compute core
(`-DPCDET_DW_CORE=0`: FFMA, `1`: 3xTF32).

At every dW launch shape of SECOND's train step at B2 and B8 (the 11 kw=3
convs under D′ and D″, conv_out under D, and the 12 convs under D for the
`rows` dW; random tables and g from a seed, the books from the train
scans) it times old, new, new, old (device time, queued behind a spin
kernel) and prints each shape's error against the plain version, whether
two new launches agree, the share of (64-row sub-tile, tap) pairs the new
kernels skip and of (live row, tap) products they multiply, and the sums
per train step.  At B2 it also times the two cores in turns (FFMA, 3xTF32,
3xTF32, FFMA), and cuBLAS's product on the pre-gathered rows of every tap
(`torch.matmul`, the math without the gather: a yardstick, not the same
function).  At every kw=3 forward shape it checks that the checkout's
selector kernels E and E′ give kernel B's bits (f32) and kernel C's (bf16)
on the same book.  Exits nonzero when a new dW kernel is off its plain
version by more than 1e-4 of max |plain| or two of its launches differ, or
E / E′ differ from B / C.
"""
import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

CORES = ('ffma', 'tf32x3')


def nvcc_build(name, sources, defines=()):
    """Builds lib<name>.so from `sources`; (loaded library, ptxas report)."""
    from pcdet_tpu_torch.ops import cuda_build
    out = cuda_build.BUILD_DIR / ('lib%s.so' % name)
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-Xptxas', '-v',
           *defines, '-I', str(sources[0].parent), '-o', str(out),
           *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    cs.require(proc.returncode == 0, 'nvcc failed for %s:\n%s' % (
        name, proc.stderr))
    lib = ctypes.CDLL(str(out))
    if hasattr(lib, 'pcdet_gather_dw_xwin'):
        lib.pcdet_gather_dw_xwin.argtypes = [ctypes.c_int] \
            + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    else:
        lib.pcdet_gather_dw.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib, proc.stderr


def old_chunk_rows(b, v_out, k):
    """The first version's chunking: enough chunks for 4 blocks per SM of
    an H100, at most 32 sub-tiles each."""
    tiles = -(-v_out // 64)
    n_chunks = -(-4 * 132 // (k * b))
    return max(1, min(32, -(-tiles // n_chunks))) * 64


class Build:
    """One build of both entries (`dw`: the library of gather_dw.cu,
    `xwin`: of gather_dw_xwin.cu) and its chunking."""

    def __init__(self, dw, xwin, core=None):
        self.dw_lib, self.xwin_lib, self.core = dw, xwin, core
        self.resident = hasattr(dw, 'pcdet_gather_dw_resident')
        if self.resident:
            dw.pcdet_gather_dw_resident.argtypes = [ctypes.c_int] * 2
            xwin.pcdet_gather_dw_xwin_resident.argtypes = [ctypes.c_int] * 4

    def rows(self, kind, b, v_out, k, cin, cout, s):
        from pcdet_tpu_torch.ops import gather_dw as gd
        if not self.resident:
            return old_chunk_rows(b, v_out, k)
        if kind == 'rows':
            n = self.dw_lib.pcdet_gather_dw_resident(cin, cout)
            return gd.chunk_rows(b, v_out, -(-k // 3), n)
        n = self.xwin_lib.pcdet_gather_dw_xwin_resident(
            int(kind == 'seg'), cin, cout, s)
        return gd.chunk_rows(b, v_out, k, n)

    def __call__(self, kind, feats, idx, sel, g, live, s):
        b, v_out, k = idx.shape
        cin, cout = feats.shape[2], g.shape[2]
        taps = k if kind == 'rows' else 3 * k
        rows = self.rows(kind, b, v_out, k, cin, cout, s)
        partial = torch.empty((b, -(-v_out // rows), taps, cin, cout),
                              device=feats.device)
        out = torch.empty((taps, cin, cout), device=feats.device)
        stream = torch.cuda.current_stream().cuda_stream
        if kind == 'rows':
            rc = self.dw_lib.pcdet_gather_dw(
                feats.data_ptr(), idx.data_ptr(), g.data_ptr(),
                live.data_ptr(), partial.data_ptr(), out.data_ptr(), b,
                feats.shape[1], v_out, k, cin, cout, rows, stream)
        else:
            from pcdet_tpu_torch.ops import gather_xwin as gx
            rc = self.xwin_lib.pcdet_gather_dw_xwin(
                int(kind == 'seg'), feats.data_ptr(), idx.data_ptr(),
                sel.data_ptr(), g.data_ptr(), live.data_ptr(),
                partial.data_ptr(), out.data_ptr(),
                gx.tally(feats.device).data_ptr(), b, feats.shape[1], v_out,
                k, cin, cout, rows, s, stream)
        cs.require(rc == 0, '%s launch failed: %d' % (kind, rc))
        return out


def package(kind, feats, idx, sel, g, live, s):
    """The checkout's kernel through its wrapper."""
    from pcdet_tpu_torch.ops import gather_dw as gd
    if kind == 'rows':
        return gd.gather_dw(feats, idx, g, live)
    if kind == 'xwin':
        return gd.gather_dw_xwin(feats, idx, sel, g, live)
    return gd.gather_dw_seg(feats, idx, sel, g, live, s=s)


def plain(kind, feats, idx, sel, g, live, s):
    from pcdet_tpu_torch.ops import gather_dw as gd
    if kind == 'rows':
        return gd.gather_dw_plain(feats, idx, g, live)
    if kind == 'xwin':
        return gd.gather_dw_xwin_plain(feats, idx, sel, g, live)
    return gd.gather_dw_seg_plain(feats, idx, sel, g, live, s=s)


def train_books(cfg, dev, batch):
    """SECOND's train books of the first `batch` train scans, by key."""
    from pcdet_tpu_torch.ops import sparse
    from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans
    pts_np, mask_np, gt_np = make_train_scans(cfg, batch, ring_keep=0.35)
    trainer = build_trainer(cfg, dev, seed=0, loads=sparse.ROWS)
    built = trainer.make_batch(torch.as_tensor(pts_np, device=dev),
                               torch.as_tensor(mask_np, device=dev), gt_np)
    return cs.level_books(built['books'], trainer.model.host_book_spec(
        trainer.max_voxels, train=True), trainer.max_voxels,
        built['voxel_mask'])


def yardstick(feats, rules, g, live):
    """ms of cuBLAS's (K, Cin, rows) @ (rows, Cout) on the pre-gathered
    rows of every tap of the live rows (misses as the zero row)."""
    x = torch.cat([feats[i, rules[i, :int(n)].long()]
                   for i, n in enumerate(live.tolist())]).transpose(0, 1)
    gl = torch.cat([g[i, :int(n)] for i, n in enumerate(live.tolist())])
    xt = x.transpose(1, 2).contiguous()                  # (K, Cin, rows)
    return cs.device_ms(lambda: torch.matmul(xt, gl), 20)


def compare(builds, kind, case, cin, cout, gen, cores):
    """One launch shape: times, errors, repeatability, skip shares."""
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    rules, n_in, _, out_mask = case
    live = out_mask.sum(1, dtype=torch.int32)
    feats = cs.rand_table(gen, case, cin, rules.device)
    g = torch.randn((rules.shape[0], rules.shape[1], cout),
                    generator=gen).to(rules.device)
    s = gx.SEG_S
    if kind == 'rows':
        idx, sel = rules, None
    else:
        idx, sel, _ = sparse.xwin_selectors(rules, n_in)
    args = (kind, feats, idx, sel, g, live, s)
    new = package(*args)
    again = package(*args)
    ref = builds['old'](*args)
    want = plain(*args)
    cs.sync()
    scale = want.abs().max().item()
    fns = {'old': lambda: builds['old'](*args), 'new': lambda: package(*args)}
    turns = [cs.device_ms(fns[v], 20) for v in ('old', 'new', 'new', 'old')]
    b, v_out, k = rules.shape
    found = ((rules >= 0) & (rules < n_in)
             & (torch.arange(v_out, device=rules.device)[None]
                < live[:, None])[..., None])
    r = {'old_ms': (turns[0] + turns[3]) / 2,
         'new_ms': (turns[1] + turns[2]) / 2, 'turns': turns,
         'repeat': bool(torch.equal(new, again)),
         'err_new': (new - want).abs().max().item() / scale,
         'err_old': (ref - want).abs().max().item() / scale,
         'same': bool(torch.equal(new, ref)),
         'skip': cs.skipped_share(rules, n_in, live, 64),
         'mult': int(found.sum()) / max(1, int(live.sum()) * k),
         'shape': (b, v_out, k, live.tolist())}
    if cores:
        for c in CORES:
            got = builds[c](*args)
            cs.sync()
            cs.require((got - want).abs().max().item() <= 1e-4 * scale,
                       '%s core off its plain version' % c)
        t = [cs.device_ms(lambda c=c: builds[c](*args), 20)
             for c in CORES + CORES[::-1]]
        r['cores'] = {c: (t[i] + t[3 - i]) / 2 for i, c in enumerate(CORES)}
        r['core_turns'] = t
        if kind != 'xwin':
            r['gemm_ms'] = yardstick(feats, rules, g, live)
    return r


def same_e_bits(case, cin, cout, gen):
    """Whether E and E′ give kernel B's (f32) and C's (bf16) bits on a kw=3
    book: [(variant, dtype, equal)]."""
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    rules, n_in, _, out_mask = case
    live = out_mask.sum(1, dtype=torch.int32)
    base, sel, _ = sparse.xwin_selectors(rules, n_in)
    groups = base.shape[2]
    table = cs.rand_table(gen, case, cin, rules.device)
    w = (torch.rand((3 * groups, cin, cout), generator=gen) * 2 - 1).to(
        rules.device) / (3 * groups * cin) ** 0.5
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        t, wt = table.to(dtype), w.to(dtype)
        rows = gg.gather_gemm(t, rules, wt, live)
        for seg in (False, True):
            new = (gx.gather_gemm_seg(t, base, sel, wt, live) if seg
                   else gx.gather_gemm_xwin(t, base, sel, wt, live))
            out.append(("E'" if seg else 'E', str(dtype)[6:],
                        bool(torch.equal(new, rows))))
    return out


def main(argv):
    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.ops import cuda_build
    from pcdet_tpu_torch.ops import gather_dw as gd
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    from pcdet_tpu_torch.ops import gather_xwin as gx
    src, old_dir = cuda_build.CSRC_DIR, Path(argv[1])
    jobs = {'old': (old_dir, ())}
    for i, c in enumerate(CORES):
        jobs[c] = (src, ('-DPCDET_DW_CORE=%d' % i,))
    with concurrent.futures.ThreadPoolExecutor(9) as pool:
        futs = {(name, part): pool.submit(
            nvcc_build, 'dw_ab_%s_%s' % (name, part),
            (d / ('gather_%s.cu' % part),), defs)
            for name, (d, defs) in jobs.items()
            for part in ('dw', 'dw_xwin')}
        for fn in (gd.build, gd.build_xwin, gx.build):
            pool.submit(fn).result()
        libs = {k: f.result() for k, f in futs.items()}
    builds = {name: Build(libs[(name, 'dw')][0], libs[(name, 'dw_xwin')][0],
                          None if name == 'old' else name)
              for name in jobs}
    for c in CORES:
        rows = cs.ptxas_entries({'ptxas': libs[(c, 'dw')][1]
                                 + libs[(c, 'dw_xwin')][1]})
        print('[dw-ab] core %s: %s' % (c, '; '.join(
            '%s<%s> %d regs, %d B spilled' % tuple(r) for r in rows)))
    cfg = detect_mod.load_config(detect_mod.SECOND_CFG)
    gen = torch.Generator(device='cpu').manual_seed(9)
    bad = []
    for batch in (2, 8):
        books = train_books(cfg, dev, batch)
        e_bits = {}
        for _, key, cin, cout in cs.KW3_CONVS:
            if (key, cin, cout) not in e_bits:
                e_bits[(key, cin, cout)] = same_e_bits(books[key], cin,
                                                       cout, gen)
        print("[dw-ab] B%d E / E' bitwise equal to kernel B (f32) and C "
              "(bf16) at the %d kw=3 forward shapes: %s" % (
                  batch, len(e_bits), all(
                      eq for r in e_bits.values() for *_, eq in r)))
        bad += [(batch, 'E', k, r) for k, rs in e_bits.items() for r in rs
                if not r[2]]
        convs = cs.KW3_CONVS + (('conv_out', 'convout', 64, 128),)
        cache, sums = {}, {}
        for conv, key, cin, cout in convs:
            kinds = ('rows',) if key == 'convout' else ('seg', 'xwin', 'rows')
            for kind in kinds:
                if (kind, key, cin, cout) not in cache:
                    cache[(kind, key, cin, cout)] = compare(
                        builds, kind, books[key], cin, cout, gen,
                        cores=batch == 2)
                r = cache[(kind, key, cin, cout)]
                name = {'rows': 'D', 'xwin': "D''", 'seg': "D'"}[kind]
                print('[dw-ab] B%d %-4s %-10s %-8s %3d -> %-3d (B, V_out, K, '
                      'live) %s: old %.4f new %.4f ms (%.2fx; old, new, new, '
                      'old %s); two new launches equal %s, new == old %s; '
                      'max error / max |plain| new %.2e old %.2e; (sub-tile, '
                      'tap) pairs skipped %.1f%%, (row, tap) products '
                      'multiplied %.1f%%'
                      % (batch, name, conv, key, cin, cout, r['shape'],
                         r['old_ms'], r['new_ms'], r['old_ms'] / r['new_ms'],
                         ', '.join('%.4f' % x for x in r['turns']),
                         r['repeat'], r['same'], r['err_new'], r['err_old'],
                         100 * r['skip'], 100 * r['mult']))
                if 'cores' in r:
                    print('[dw-ab] B%d %-4s %-10s cores: %s (ffma, tf32x3, '
                          'tf32x3, ffma %s)%s' % (
                              batch, name, conv, ', '.join(
                                  '%s %.4f ms' % x for x in r['cores'].items()),
                              ', '.join('%.4f' % x for x in r['core_turns']),
                              '; cuBLAS on the pre-gathered rows %.4f ms'
                              % r['gemm_ms'] if 'gemm_ms' in r else ''))
                if not r['repeat'] or r['err_new'] > 1e-4:
                    bad.append((batch, kind, conv))
                step = kind if key != 'convout' else 'convout'
                for v in ('old', 'new'):
                    sums[(step, v)] = sums.get((step, v), 0.0) + r[v + '_ms']
        print('[dw-ab] B%d shapes where new == old: %d of %d' % (
            batch, sum(r['same'] for r in cache.values()), len(cache)))
        for v in ('old', 'new'):
            print("[dw-ab] B%d %s per train step: D' over the 11 kw=3 convs "
                  "%.4f ms, D at conv_out %.4f ms (default loads: %.4f ms); "
                  "D'' over the 11 %.4f ms; D over the 12 convs (rows dW) "
                  "%.4f ms" % (
                      batch, v, sums[('seg', v)], sums[('convout', v)],
                      sums[('seg', v)] + sums[('convout', v)],
                      sums[('xwin', v)],
                      sums[('rows', v)] + sums[('convout', v)]))
    print('[dw-ab] shapes off plain, not repeatable or E / E\' not B\'s / '
          'C\'s bits: %s' % bad)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
