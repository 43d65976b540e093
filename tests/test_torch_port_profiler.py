"""The port's `utils/profiler.py` on the CPU: `span` is the shared no-op
with no profiler recording and a `record_function` range under one,
nested in its caller's span; the flag it reads is pinned; tiny PointPillar
and SECOND detects and a SECOND `Trainer.step` show the program's spans
(`pcdet.*`) in order, `pcdet.nms.round` once per call of NMS's overlap
function; `trace` writes a Chrome trace of host activity, spans included,
into its directory.
"""
import json

import torch
from torch.profiler import ProfilerActivity, profile

from tiny_config import tiny_pointpillar_cfg, tiny_second_cfg

from pcdet_tpu_torch import detect
from pcdet_tpu_torch.ops import nms, rotated_overlap
from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans
from pcdet_tpu_torch.utils import profiler

torch.set_num_threads(1)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _spans(prof):
    """The program's spans in start order: [(name, start, end)]."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith('pcdet.')]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _work():
    x = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    return (x @ x).sum()


def _detector(cfg):
    det = detect.build_detector(cfg, 'cpu', seed=0)
    # the focal prior keeps every score under SCORE_THRESH: with the bias
    # zeroed NMS gets candidates and runs its rounds
    det.model.module.rpn_head.conv_cls.bias.data.zero_()
    points, mask = detect.make_scans(cfg, batch=2)
    return det, torch.as_tensor(points), torch.as_tensor(mask)


def test_span_without_a_profiler_is_the_shared_no_op():
    a, b = profiler.span('pcdet.a'), profiler.span('pcdet.b')
    assert a is b is profiler._NO_SPAN
    with profiler.span('pcdet.off'):
        _work()
    prof = _profiled(_work)
    assert 'pcdet.off' not in {e.name for e in prof.events()}


def test_span_under_a_profiler_is_a_nested_record_function_range():
    def fn():
        with profiler.span('pcdet.outer'):
            with profiler.span('pcdet.inner') as inner:
                assert isinstance(inner, torch.profiler.record_function)
                _work()
    prof = _profiled(fn)
    events = {e.name: e for e in prof.events()
              if e.name.startswith('pcdet.')}
    assert set(events) == {'pcdet.outer', 'pcdet.inner'}
    assert events['pcdet.inner'].cpu_parent is events['pcdet.outer']
    ops = [e for e in prof.events() if e.name == 'aten::matmul']
    assert len(ops) == 1 and ops[0].cpu_parent is events['pcdet.inner']
    # a span opened while recording is no no-op, one opened after is
    assert profiler.span('pcdet.after') is profiler._NO_SPAN


def test_the_profiler_flag_span_reads():
    """`span` reads `torch.autograd.profiler._is_profiler_enabled`, which
    `torch.profiler.profile` sets on start and clears on stop: a torch
    that drops or renames it fails here."""
    flag = torch.autograd.profiler
    assert flag._is_profiler_enabled is False
    seen = []
    _profiled(lambda: seen.append(flag._is_profiler_enabled))
    assert seen == [True] and flag._is_profiler_enabled is False


def test_pointpillar_detect_spans(monkeypatch):
    det, points, mask = _detector(tiny_pointpillar_cfg(num_class=3))
    calls = []

    def overlap(a, b):
        calls.append(1)
        return rotated_overlap.pair_overlap_batched(a, b)

    nms_bev_batched = nms.nms_bev_batched
    monkeypatch.setattr(nms, 'nms_bev_batched', lambda *a, **k:
                        nms_bev_batched(*a, **k, overlap_fn=overlap))
    spans = _spans(_profiled(lambda: det.detect(points, mask)))
    stages = [s for s in spans if s[0] != 'pcdet.nms.round']
    assert [s[0] for s in stages] == ['pcdet.voxelize', 'pcdet.vfe',
                                      'pcdet.rpn', 'pcdet.predict']
    for a, b in zip(stages, stages[1:]):
        assert a[2] <= b[1]
    rounds = [s for s in spans if s[0] == 'pcdet.nms.round']
    assert len(rounds) == len(calls) > 0
    assert all(_inside(r, stages[-1]) for r in rounds)


def test_second_detect_spans_the_books():
    det, points, mask = _detector(tiny_second_cfg(num_class=3))
    spans = _spans(_profiled(lambda: det.detect(points, mask)))
    names = [s[0] for s in spans if s[0] != 'pcdet.nms.round']
    assert names == ['pcdet.voxelize', 'pcdet.books', 'pcdet.vfe',
                     'pcdet.rpn', 'pcdet.predict']


def test_trainer_step_spans():
    cfg = tiny_second_cfg(num_class=3)
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=4)
    points, mask, gt = make_train_scans(cfg, 2)
    batch = trainer.make_batch(torch.as_tensor(points),
                               torch.as_tensor(mask), gt)
    spans = _spans(_profiled(lambda: trainer.step(batch)))
    step = [s for s in spans if s[0] in ('pcdet.forward', 'pcdet.backward',
                                         'pcdet.optimizer')]
    assert [s[0] for s in step] == ['pcdet.forward', 'pcdet.backward',
                                    'pcdet.optimizer']
    for a, b in zip(step, step[1:]):
        assert a[2] <= b[1]
    # the forward's stages sit inside it; the pool built the books
    inner = [s for s in spans if s not in step]
    assert {s[0] for s in inner} == {'pcdet.vfe', 'pcdet.rpn'}
    assert all(_inside(s, step[0]) for s in inner)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / 'trace'
    with profiler.trace(str(logdir)) as prof:
        _work()
    files = sorted(logdir.glob('*.pt.trace.json'))
    assert len(files) == 1
    events = json.loads(files[0].read_text())['traceEvents']
    names = {e.get('name') for e in events}
    assert 'aten::mm' in names
    assert any(row.key == 'aten::mm' for row in prof.key_averages())


def test_trace_holds_the_program_spans(tmp_path):
    det, points, mask = _detector(tiny_pointpillar_cfg(num_class=1))
    with profiler.trace(str(tmp_path)):
        det.detect(points, mask)
    files = list(tmp_path.glob('*.pt.trace.json'))
    assert len(files) == 1
    events = json.loads(files[0].read_text())['traceEvents']
    names = {e.get('name') for e in events}
    assert {'pcdet.voxelize', 'pcdet.vfe', 'pcdet.rpn', 'pcdet.predict',
            'pcdet.nms.round'} <= names
