"""The port's `utils/profiler.py` against `pcdet_tpu.utils.profiler`:
`StepTimer` gives `pcdet_tpu`'s numbers on the same tic / toc sequence
under a patched `time.perf_counter` (the window's rollover, `n_examples`,
a toc without a tic, the empty meter), and `trace` writes a Chrome trace
of host activity into its directory on the CPU.
"""
import json

import pytest
import torch

from pcdet_tpu.utils import profiler as jax_profiler
from pcdet_tpu_torch.utils import profiler

# (tic or toc, n_examples) and the clock's readings, in seconds
_EVENTS = [('toc', 3), ('tic', None), ('toc', 2), ('tic', None), ('toc', 5),
           ('toc', 7), ('tic', None), ('toc', 1), ('tic', None), ('toc', 4),
           ('tic', None), ('toc', 6), ('tic', None), ('toc', 2)]


def _drive(module, window, monkeypatch):
    """The meter's (sec_per_step, examples_per_sec, sec_per_example,
    times, counts) after each event, the clock advancing by uneven steps."""
    clock = iter([0.5 * i * i + 0.125 * i for i in range(1, 100)])
    monkeypatch.setattr(module.time, 'perf_counter', lambda: next(clock))
    timer = module.StepTimer(window=window)
    out = [(timer.sec_per_step, timer.examples_per_sec,
            timer.sec_per_example)]
    for what, n in _EVENTS:
        if what == 'tic':
            timer.tic()
        else:
            timer.toc(n)
        out.append((timer.sec_per_step, timer.examples_per_sec,
                    timer.sec_per_example, list(timer.times),
                    list(timer.counts)))
    return out


@pytest.mark.parametrize('window', [2, 3, 50])
def test_step_timer_equals_pcdet_tpu(window, monkeypatch):
    got = _drive(profiler, window, monkeypatch)
    want = _drive(jax_profiler, window, monkeypatch)
    assert got == want
    assert got[0] == (0.0, 0.0, 0.0)
    assert len(got[-1][3]) == min(window, 6)


def test_step_timer_default_toc_counts_one(monkeypatch):
    clock = iter([1.0, 1.25, 2.0, 2.5])
    monkeypatch.setattr(profiler.time, 'perf_counter', lambda: next(clock))
    timer = profiler.StepTimer()
    for _ in range(2):
        timer.tic()
        timer.toc()
    assert timer.counts == [1, 1] and timer.times == [0.25, 0.5]
    assert timer.sec_per_step == 0.375
    assert timer.examples_per_sec == 2 / 0.75
    assert timer.sec_per_example == 0.375


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / 'trace'
    with profiler.trace(str(logdir)) as prof:
        x = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
        (x @ x).sum()
    files = sorted(logdir.glob('*.pt.trace.json'))
    assert len(files) == 1
    events = json.loads(files[0].read_text())['traceEvents']
    names = {e.get('name') for e in events}
    assert 'aten::mm' in names
    assert any(row.key == 'aten::mm' for row in prof.key_averages())
