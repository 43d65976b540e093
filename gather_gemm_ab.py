"""Two builds of the gather-GEMM kernels B and C, timed in turns on one GPU.

    python3 gather_gemm_ab.py OLD_SOURCE

OLD_SOURCE is another version of `pcdet_tpu_torch/csrc/gather_gemm.cu`
with the same C entry point (`pcdet_gather_gemm`), for example one taken
from git (`git show REV:pcdet_tpu_torch/csrc/gather_gemm.cu > build/old.cu`).
It is built with the port's nvcc flags beside the library the port builds
from the checkout.  At every launch shape of SECOND's main path at B2 (the
11 kw=3 convs and conv_out: the forward in bf16 on the eval books, C; the
forward and the feature gradient in f32 on the train books, B; random
tables and weights from a seed) it times old, new, new, old (device time,
queued behind a spin kernel), checks that the new f32 output equals the old
one bit for bit and that two new launches agree, and prints each error
against the plain version, the share of (tile, tap) pairs the new kernels
skip, and the sums per train step (12 forward and 11 feature-gradient
launches of B) and per detect batch (12 launches of C).  Exits nonzero
when the f32 outputs differ.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs


def build_old(src):
    from pcdet_tpu_torch.ops import cuda_build
    out = cuda_build.BUILD_DIR / 'libgather_gemm_ab_old.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-o',
                    str(out), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.pcdet_gather_gemm.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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
    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.ops import gather_gemm as gg
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
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
    bad = [k for k, r in cache.items() if 'f32' in k[0] and not r['same']]
    print('[ab] f32 shapes where the new B differs from the old: %s' % bad)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
