"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload second.train.b8 --seed 7 \
        --seconds 20 --trace 0

The cell is `benchmark/workloads/<workload>.json`; it names its
configuration (`benchmark/configs/<config>.json`) and its entry
(`benchmark/entries/<entry>.py`); the per-layer readers are
`benchmark/metrics/<metric>.py`, one a metric, and `BENCHMARK.json` says
which metrics a cell reports.  With --trace 0 the run measures the window
and prints the cell's end-to-end metrics; with --trace 1 it traces a short
slice instead and prints its per-layer metrics.  Either way it then checks
what the timed path produced against the plain reference
(`benchmark/reference/`), prints each number compared beside its limit,
and as the last line of standard output one JSON object.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pcdet_tpu')


def forbidden_modules():
    """Top-level names of loaded modules that the run must not hold,
    compared whole (`pcdet_tpu_torch` is not `pcdet_tpu`)."""
    tops = {name.split('.')[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def benchmark_json():
    from benchmark.harness import common
    return json.loads((common.ROOT.parent / 'BENCHMARK.json').read_text())


def cell_metrics(bench, name, trace):
    """Names of the metrics this cell prints: BENCHMARK.json's end-to-end
    (or per-layer, traced) metrics that list the cell, or that list no
    cells and move a metric the cell reports."""
    e2e = [m for m in bench['end_to_end']
           if name in m.get('workloads', [name])]
    if not trace:
        return [m['name'] for m in e2e]
    names = {m['name'] for m in e2e}

    def listed(m):
        return (name in m['workloads'] if 'workloads' in m
                else m['moves'] in names)
    return [m['name'] for m in bench['per_layer'] if listed(m)]


def load_reader(metric):
    """The reader module of a per-layer metric, found by its name:
    `read(summary)` gives the value or None, `UNIT` its unit."""
    from benchmark.harness import common
    path = common.ROOT / 'metrics' / (metric + '.py')
    spec = importlib.util.spec_from_file_location(
        'bench_metric_' + metric.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    def __init__(self, args):
        from benchmark.harness import common
        from benchmark.reference.net import RefModel
        self.name = args.workload
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.work, self.conf = common.load_cell(args.workload)
        self.cfg = common.program_cfg(self.conf['model'], self.work['config'])
        self.ref = RefModel(self.conf['model'])
        self.failed = 0
        self.device = None

    def note(self, msg):
        print('[bench] ' + msg, file=sys.stderr, flush=True)

    def stage(self, name):
        """Note the seconds of set-up since the last stage (or the start)."""
        stage(name)


_MARK = [T_START]


def stage(name):
    now = time.perf_counter()
    print('[bench] setup stage %s %.4f' % (name, now - _MARK[0]),
          file=sys.stderr, flush=True)
    _MARK[0] = now


def require_cards(chips):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('benchmark: torch.cuda.is_available() is false')
    if torch.cuda.device_count() < chips:
        raise SystemExit('benchmark: %d cards, the cell needs %d'
                         % (torch.cuda.device_count(), chips))


def main(argv=None, device='cuda'):
    """One run; `device` other than 'cuda' skips the look for cards and
    runs the program's plain paths there (the CPU tests)."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault('USE_FLAX', '0')

    from benchmark.harness import common
    work, conf = common.load_cell(args.workload)
    if not work.get('limits'):
        # a cell with nothing to compare would read correct on any output
        raise SystemExit('benchmark: the workload %s sets no correctness '
                         'limits' % args.workload)
    if device == 'cuda':
        require_cards(int(work['chips']))
    import torch
    stage('imports')
    ctx = Context(args)
    ctx.device = torch.device(device)
    if device == 'cuda':
        torch.cuda.init()
        torch.empty(1, device=device)
        stage('cuda context')
    entry = importlib.import_module('benchmark.entries.' + work['entry'])
    st = entry.setup(ctx)
    setup_s = time.perf_counter() - T_START
    ctx.note('setup_s %.4f' % setup_s)
    bench = benchmark_json()
    if ctx.trace:
        summary, record = entry.traced(st, ctx)
        summary.update(entry=work['entry'], cell=ctx.name)
        attempted = summary['batches']
        metrics = {}
        for m in cell_metrics(bench, ctx.name, True):
            reader = load_reader(m)
            value = reader.read(summary)
            if value is not None:
                metrics[m] = {'value': value, 'unit': reader.UNIT}
    else:
        produced, record = entry.window(st, ctx)
        produced['setup_s'] = (setup_s, 's')
        attempted = len(record) if isinstance(record, list) else record
        metrics = {m: {'value': produced[m][0], 'unit': produced[m][1]}
                   for m in cell_metrics(bench, ctx.name, False)}
    dev = common.device_info(ctx.device, int(work['chips']))
    if ctx.trace:
        dev['busy_s'] = summary['busy_s']
        dev['window_s'] = summary['window_s']
    entry.free(st)
    values = entry.check(st, ctx, record)
    limits = work['limits']
    checks = {}
    correct = True
    for k, v in values.items():
        if k not in limits:
            print('reading %s %.6g (not compared)' % (k, v), file=sys.stderr)
            continue
        ok = math.isfinite(v) and v <= limits[k]
        correct = correct and ok
        checks[k] = {'value': v, 'limit': limits[k]}
    failed = ctx.failed
    if failed:
        correct = False
    for k, c in checks.items():
        print('check %s %.6g limit %.6g' % (k, c['value'], c['limit']),
              file=sys.stderr)
    out = {'correct': bool(correct), 'attempted': int(attempted),
           'failed': int(failed), 'metrics': metrics, 'device': dev}
    if ctx.trace:
        out['breakdown'] = summary['breakdown']
    out['checks'] = checks
    # the window and the check have run: nothing of either may have loaded
    # JAX or the JAX package
    found = forbidden_modules()
    if found:
        raise SystemExit('benchmark: the run loaded %s' % ', '.join(found))
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
