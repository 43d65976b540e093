"""`harness/spans.py` on the CPU: attribution by launch time on hand-built
events (a kernel that runs after its span, a launch from another thread,
nested spans, idle inside a span), readings from span counts alone, and
the tiny cells' traced slices, whose spans it finds with no device event
to attribute."""
import argparse
import importlib

import pytest
import torch

from benchmark import run
from benchmark.harness import common, spans, trace
from benchmark.tests import tiny


def _event(name, start, end, device=False, id=0, linked=0):
    """An event as `spans.events` gives it."""
    return (name, device, start, end, id, linked)


def _attributed(events):
    return spans.attribute(*spans.intervals(events))


def test_a_kernel_that_runs_after_its_span_counts_to_it():
    out, unlaunched = _attributed([
        _event('pcdet.a', 0, 10, id=1),
        _event('cudaLaunchKernel', 5, 6, id=40, linked=1),
        _event('kernel_x', 20, 30, device=True, id=40, linked=1),
        # the range's own mark on the device timeline is no kernel
        _event('pcdet.a', 20, 30, device=True, id=41)])
    a = out['pcdet.a']
    assert a['n'] == 1 and a['device_s'] == pytest.approx(10e-6)
    assert a['host_s'] == pytest.approx(10e-6)
    assert a['idle_s'] == pytest.approx(10e-6)
    assert unlaunched == 0


def test_a_launch_from_another_thread_counts_to_the_open_span():
    out, _ = _attributed([
        _event('pcdet.backward', 0, 100, id=1),
        # autograd's device thread: the op and its launch, on no span
        _event('aten::mul', 30, 40, id=2),
        _event('cudaLaunchKernel', 32, 33, id=70, linked=2),
        _event('mul_kernel', 35, 45, device=True, id=70, linked=2),
        # launched after the span closed: not the span's
        _event('cudaLaunchKernel', 101, 102, id=71, linked=2),
        _event('add_kernel', 103, 108, device=True, id=71, linked=2)])
    assert out['pcdet.backward']['device_s'] == pytest.approx(10e-6)


def test_nested_spans_are_inclusive():
    out, _ = _attributed([
        _event('pcdet.outer', 0, 100),
        _event('pcdet.inner', 10, 20),
        _event('cudaLaunchKernel', 15, 16, id=7, linked=3),
        _event('k1', 16, 21, device=True, id=7, linked=3),
        _event('cudaLaunchKernel', 50, 51, id=8, linked=3),
        _event('k2', 51, 56, device=True, id=8, linked=3)])
    assert out['pcdet.inner']['device_s'] == pytest.approx(5e-6)
    assert out['pcdet.outer']['device_s'] == pytest.approx(10e-6)


def test_idle_is_the_span_less_the_device_intervals():
    # two intervals of one span overlap; the device is busy over
    # [10, 40] and [90, 120], partly outside the span's union [0, 150]
    launches = [(None, 10, 30), (None, 25, 40), (None, 90, 120),
                (None, 200, 210)]
    out, unlaunched = spans.attribute(
        {'pcdet.a': [(0, 100), (50, 150)]}, launches)
    a = out['pcdet.a']
    assert a['n'] == 2 and a['host_s'] == pytest.approx(200e-6)
    assert a['idle_s'] == pytest.approx((150 - 30 - 30) * 1e-6)
    assert a['device_s'] == 0
    # device time sums the intervals, overlaps and all
    assert unlaunched == pytest.approx(75e-6)


def test_nms_rounds_read_from_span_counts_alone():
    summary = {'spans': {'pcdet.nms.round': {'n': 14, 'host_s': 1.0,
                                             'device_s': 0.0,
                                             'idle_s': 0.0},
                         'pcdet.predict': {'n': 2, 'host_s': 1.0,
                                           'device_s': 0.0, 'idle_s': 0.0}},
               'unlaunched_s': 0.0, 'device_events': 0}
    assert spans.reading(summary, 2, 'nms_rounds.detect') == 7
    assert spans.reading(summary, 2, 'device_ms.predict.detect') is None
    assert spans.reading(summary, 2, 'idle_ms.predict.detect') is None
    assert spans.reading(summary, 2, 'device_ms.vfe.detect') is None
    summary['device_events'] = 3
    assert spans.reading(summary, 2, 'device_ms.predict.detect') == 0


@pytest.fixture
def bench(tmp_path, monkeypatch):
    root = tiny.tiny_bench(tmp_path)
    monkeypatch.setattr(common, 'ROOT', root)
    return root


def _traced_slice(cell, n=2, start=lambda: None):
    """The tiny cell's traced slice as its entry takes it, on the CPU, with
    `start()` called after set-up: (spans.summarize's dict, batches)."""
    ctx = run.Context(argparse.Namespace(workload=cell, seed=2147483713,
                                         seconds=0, trace=1))
    ctx.device = torch.device('cpu')
    entry = importlib.import_module('benchmark.entries.' + ctx.work['entry'])
    st = entry.setup(ctx)
    one = entry.run_batch if ctx.work['entry'] == 'detect' else entry.step
    start()
    prof, _, _ = trace.run_traced(lambda k: one(st, k % st.batches), n)
    return spans.summarize(prof), n


def test_tiny_detect_slice_on_the_cpu(bench, monkeypatch):
    from pcdet_tpu_torch.ops import nms, rotated_overlap
    calls = []

    def overlap(a, b):
        calls.append(1)
        return rotated_overlap.pair_overlap_batched(a, b)

    nms_bev_batched = nms.nms_bev_batched
    monkeypatch.setattr(nms, 'nms_bev_batched', lambda *a, **k:
                        nms_bev_batched(*a, **k, overlap_fn=overlap))
    summary, n = _traced_slice('pointpillar.detect.b8', start=calls.clear)
    got = summary['spans']
    for name in ('pcdet.voxelize', 'pcdet.vfe', 'pcdet.rpn', 'pcdet.predict',
                 'bench.batch', 'bench.upload', 'bench.detect',
                 'bench.download'):
        assert got[name]['n'] == n, name
    assert summary['device_events'] == 0
    assert got['pcdet.nms.round']['n'] == len(calls) > 0
    for metric in spans.READINGS:
        value = spans.reading(summary, n, metric)
        if metric == 'nms_rounds.detect':
            assert value == len(calls) / n
        else:
            assert value is None, metric


def test_tiny_train_slice_on_the_cpu(bench):
    summary, n = _traced_slice('second.train.b8')
    got = summary['spans']
    for name in ('pcdet.forward', 'pcdet.backward', 'pcdet.optimizer',
                 'pcdet.vfe', 'pcdet.rpn', 'bench.step'):
        assert got[name]['n'] == n, name
    assert 'pcdet.books' not in got and 'pcdet.predict' not in got
    assert spans.reading(summary, n, 'device_ms.forward.train') is None
