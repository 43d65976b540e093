"""Readings that set the correctness limits, at the cell's own size.

    python3 benchmark/control.py --workload second.train.b8 --what program \
        --seeds 11,12,13 --seconds 2 --out readings.jsonl

`--what`:
  program - the harness's own path for each seed (set-up, a window of
      `--seconds`, the check): the lower readings;
  control - the reference in the next precision below the configuration's,
      in the program's place: float8 (e4m3) for the bf16 eval stacks of
      the detect cells, bfloat16 for training's float32 (TF32 on);
  half - training: the reference stepping on half of each batch, the mean
      taken over that half (a planted fault).
A state left unchanged reads 1 on change_gap by its definition and needs
no run.  All seeds run in one process; each prints one JSON line.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.entries import detect, train  # noqa: E402


def detect_control(ctx):
    st = detect.prepare(ctx)
    ctx.params_dev = st.weights
    b = st.batch
    picked = detect.sample(ctx, [(i, None) for i in range(st.batches)])
    idx = [i for i, _ in picked]
    pts = torch.cat([torch.as_tensor(st.points[i * b:(i + 1) * b])
                     for i in idx]).numpy()
    msk = torch.cat([torch.as_tensor(st.mask[i * b:(i + 1) * b])
                     for i in idx]).numpy()
    low = detect.reference_runs(ctx, pts, msk, lower=True)
    dets = [(r['boxes'], r['scores'], r['labels']) for r in low]
    refs = detect.reference_runs(ctx, pts, msk)
    anchors = torch.as_tensor(detect.Anchors(ctx.ref.cfg, ctx.ref.grid)
                              .anchors, device=ctx.device)
    return detect.compare(dets, refs, anchors)


def train_fault(ctx, what):
    st = train.prepare(ctx)
    refr = train.reference_steps(ctx, st)
    if what == 'control':
        prog = train.reference_steps(ctx, st, lower=True)
    else:
        half = st.batch // 2
        prog = train.reference_steps(
            ctx, st, keep=lambda p, m, g: (p[:half], m[:half], g[:half]))
    values = train.compare(prog, refr)
    values.update(train.diagnostics(prog, refr))
    return values


def program(ctx, entry):
    st = entry.setup(ctx)
    _, record = entry.window(st, ctx)
    entry.free(st)
    values = entry.check(st, ctx, record)
    values['failed'] = ctx.failed
    values.update(getattr(ctx, 'diagnostics', {}))
    return values


def main(argv=None, device='cuda'):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--what', required=True,
                    choices=('program', 'control', 'half'))
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(',')]
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = run.Context(argparse.Namespace(
            workload=args.workload, seed=seed, seconds=args.seconds,
            trace=0))
        ctx.device = torch.device(device)
        entry = detect if ctx.work['entry'] == 'detect' else train
        if args.what == 'program':
            values = program(ctx, entry)
        elif entry is detect:
            values = detect_control(ctx)
        else:
            values = train_fault(ctx, args.what)
        row = {'workload': args.workload, 'what': args.what, 'seed': seed,
               'values': values, 'seconds': time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(json.dumps(row) + '\n')
        rows.append(row)
        del ctx
        gc.collect()
        if device == 'cuda':
            torch.cuda.empty_cache()
    return rows


if __name__ == '__main__':
    main()
