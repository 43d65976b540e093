"""On the card: the program's spans in each cell's traced slice, at the
cell's own size, account for its device time.

    python -m pytest -m gpu benchmark/tests/test_bench_spans_gpu.py -q -s

- `second.train.b8`: the device time launched under `pcdet.forward`,
  `pcdet.backward` and `pcdet.optimizer` is within 3% of the slice's busy
  time a step;
- `pointpillar.detect.b8`: under `pcdet.voxelize`, `pcdet.vfe`,
  `pcdet.rpn` and `pcdet.predict`, within 5% of the busy time a batch less
  the device time launched under `bench.upload` and `bench.download`; the
  idle under `pcdet.predict` is no more than the slice's; the count of
  `pcdet.nms.round` equals the launches of kernel A over the slice
  (`rotated_overlap.LAUNCHES`).

Each test prints its slice's readings (`slice_readings`) as one JSON line.
"""
import argparse
import importlib
import json

import pytest

from benchmark import run
from benchmark.harness import spans, trace

SEED = 3000000021


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the port\'s hand-written kernels')


def slice_readings(cell, seed=SEED):
    """Set up `cell` on the card as its run does and trace its slice (the
    workload's `traced_batches`, in the entry's seeded order): the slice's
    busy, idle and window ms a batch, the spans' attribution, the
    `READINGS` metrics, and kernel A's launches over the slice."""
    import torch
    from pcdet_tpu_torch.ops import rotated_overlap
    ctx = run.Context(argparse.Namespace(workload=cell, seed=seed,
                                         seconds=0, trace=1))
    ctx.device = torch.device('cuda')
    entry = importlib.import_module('benchmark.entries.' + ctx.work['entry'])
    st = entry.setup(ctx)
    one = entry.run_batch if ctx.work['entry'] == 'detect' else entry.step
    seq = entry.order(ctx, st.batches)
    n = int(ctx.work['traced_batches'])
    idx = [int(next(seq)) for _ in range(n)]
    launches = rotated_overlap.LAUNCHES
    prof, wall, _ = trace.run_traced(lambda k: one(st, idx[k]), n)
    launches = rotated_overlap.LAUNCHES - launches
    summary = trace.summarize(prof, wall)
    sp = spans.summarize(prof)
    return {'cell': cell, 'seed': seed, 'batches': n,
            'device': torch.cuda.get_device_name(0),
            'window_ms': 1e3 * wall / n,
            'busy_ms': 1e3 * summary['busy_s'] / n,
            'idle_ms': 1e3 * (wall - summary['busy_s']) / n,
            'kernel_a_launches': launches,
            'readings': {m: spans.reading(sp, n, m) for m in spans.READINGS},
            'spans': sp['spans'], 'unlaunched_s': sp['unlaunched_s'],
            'idle_gaps': summary['breakdown']['idle_gaps']}


def _device_ms(r, name):
    s = r['spans'].get(name)
    return 0.0 if s is None else 1e3 * s['device_s'] / r['batches']


@pytest.mark.gpu
def test_train_spans_hold_the_busy_time(card):
    r = slice_readings('second.train.b8')
    print(json.dumps(r))
    got = [r['readings']['%s.train' % k] for k in (
        'device_ms.forward', 'device_ms.backward', 'device_ms.optimizer',
        'idle_ms.optimizer')]
    assert None not in got, r['readings']
    assert abs(sum(got[:3]) - r['busy_ms']) <= 0.03 * r['busy_ms'], r


@pytest.mark.gpu
def test_detect_spans_hold_the_busy_time(card):
    r = slice_readings('pointpillar.detect.b8')
    print(json.dumps(r))
    got = {m: v for m, v in r['readings'].items() if m.endswith('.detect')}
    assert None not in got.values(), got
    stages = sum(got['device_ms.%s.detect' % k]
                 for k in ('voxelize', 'vfe', 'rpn', 'predict'))
    busy = (r['busy_ms'] - _device_ms(r, 'bench.upload')
            - _device_ms(r, 'bench.download'))
    assert abs(stages - busy) <= 0.05 * busy, r
    assert got['idle_ms.predict.detect'] <= r['idle_ms']
    assert got['nms_rounds.detect'] * r['batches'] == \
        r['kernel_a_launches'] > 0
