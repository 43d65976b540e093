"""Kernel F (one launch a call) against the eager NMS rounds (kernel A with
the rounds on the host), on the NMS inputs of a benchmark cell, on one GPU.

    python3 nms_fused_ab.py [--cell pointpillar.detect.b8] [--seed N]
        [--reps 20]

Sets the cell up as its run does (weights from the seed, BN calibration,
the pool of scans), records the arguments of every `nms_bev_batched` call
of one detect of each pool batch, and on those inputs:
- checks that F's `selected` and `num` equal the eager loop's bit for bit
  and that each group's device round count equals the eager rounds of that
  group alone;
- times both in turns (F, eager, eager, F), each call a whole
  `nms_bev_batched` on the card: the wall time a call (host clock, a
  synchronize after each), the device time a call (torch.profiler, every
  kernel launched inside it) and, for F, kernel F's own device time.
Prints one JSON line per pool batch and a summary line (medians) last, with
the card's name and power limit.  Exits nonzero when a check fails.
"""
import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def card():
    q = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True)
    return q.stdout.strip().splitlines()[0] if q.returncode == 0 else '?'


def record_calls(cell, seed):
    """[(args, kwargs)] of every nms_bev_batched call of one detect of each
    pool batch, on the card."""
    from benchmark import run
    from pcdet_tpu_torch.ops import nms
    ctx = run.Context(argparse.Namespace(workload=cell, seed=seed, seconds=0,
                                         trace=0))
    ctx.device = torch.device('cuda')
    entry = importlib.import_module('benchmark.entries.' + ctx.work['entry'])
    st = entry.setup(ctx)
    calls = []
    real = nms.nms_bev_batched

    def rec(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    nms.nms_bev_batched = rec
    try:
        for i in range(st.batches):
            entry.run_batch(st, i)
    finally:
        nms.nms_bev_batched = real
    torch.cuda.synchronize()
    return calls


def _eager_overlap(a, b):
    from pcdet_tpu_torch.ops import rotated_overlap
    return rotated_overlap.pair_overlap_batched(a, b)


def eager(a, k):
    """The eager loop -> (selected, num, rounds)."""
    from pcdet_tpu_torch.ops import nms
    rounds = []
    suppress = nms._greedy_suppress_batched

    def counted(*x, **y):
        rounds.append(1)
        return suppress(*x, **y)

    nms._greedy_suppress_batched = counted
    try:
        sel, num = nms.nms_bev_batched(*a, **dict(k, overlap_fn=_eager_overlap))
    finally:
        nms._greedy_suppress_batched = suppress
    return sel, num, len(rounds)


def check(a, k):
    from pcdet_tpu_torch.ops import nms
    sel, num = nms.nms_bev_batched(*a, **k)
    rounds = nms.last_device_rounds().cpu().tolist()
    want = eager(a, k)
    ok = torch.equal(sel, want[0]) and torch.equal(num, want[1])
    per_group = []
    for g in range(a[0].shape[0]):
        one = [x[g:g + 1] if torch.is_tensor(x) else x for x in a]
        kk = {n: (v[g:g + 1] if torch.is_tensor(v) else v)
              for n, v in k.items()}
        per_group.append(eager(one, kk)[2])
    return ok and rounds == per_group, rounds, want[2], int(num.sum())


def wall_ms(fn, reps):
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def device_ms(fn, reps):
    """(device ms a call over every kernel, kernel F's ms a call)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = fused = 0.0
    for e in prof.key_averages():
        # kernels and copies only: a span shows on the device timeline too
        if e.device_type != DeviceType.CUDA or e.key.startswith('pcdet.'):
            continue
        total += e.self_device_time_total
        if 'nms_fused_kernel' in e.key:
            fused += e.self_device_time_total
    return total / 1e3 / reps, fused / 1e3 / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cell', default='pointpillar.detect.b8')
    ap.add_argument('--seed', type=int, default=2305843009)
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args()
    from pcdet_tpu_torch.ops import nms
    calls = record_calls(args.cell, args.seed)
    rows, bad = [], 0
    for i, (a, k) in enumerate(calls):
        ok, rounds, eager_rounds, kept = check(a, k)
        bad += not ok

        def fused():
            nms.nms_bev_batched(*a, **k)

        def loop():
            eager(a, k)

        t = {}
        for name, fn in (('fused', fused), ('eager', loop), ('eager', loop),
                         ('fused', fused)):
            fn()
            w = wall_ms(fn, args.reps)
            d, f = device_ms(fn, args.reps)
            t.setdefault(name, []).append((w, d, f))
        row = {'call': i, 'shape': list(a[0].shape), 'equal': ok,
               'device_rounds': rounds, 'eager_rounds': eager_rounds,
               'kept': kept,
               'fused_wall_ms': [x[0] for x in t['fused']],
               'fused_device_ms': [x[1] for x in t['fused']],
               'kernel_f_ms': [x[2] for x in t['fused']],
               'eager_wall_ms': [x[0] for x in t['eager']],
               'eager_device_ms': [x[1] for x in t['eager']]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    med = {key: statistics.median(v for r in rows for v in r[key])
           for key in ('fused_wall_ms', 'fused_device_ms', 'kernel_f_ms',
                       'eager_wall_ms', 'eager_device_ms')}
    med.update({'cell': args.cell, 'seed': args.seed, 'calls': len(rows),
                'all_equal': bad == 0, 'card': card(),
                'device_rounds_max': max(max(r['device_rounds'])
                                         for r in rows),
                'eager_rounds': [r['eager_rounds'] for r in rows]})
    print(json.dumps(med), flush=True)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
