"""The harness on the CPU at tiny sizes: files found by name, the import
check, the work counters against hand counts, and the run's own result."""
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import common, flops, roofline
from benchmark.reference import sparse
from benchmark.reference.net import RefModel, identity
from benchmark.tests import tiny


@pytest.fixture
def bench(tmp_path, monkeypatch):
    root = tiny.tiny_bench(tmp_path)
    monkeypatch.setattr(common, 'ROOT', root)
    return root


def run_cell(cell, trace=0, seconds=0.5):
    return run.main(['--workload', cell, '--seed', '2147483701',
                     '--seconds', str(seconds), '--trace', str(trace)],
                    device='cpu')


def test_added_files_are_found_by_name(bench):
    """A configuration, a cell and a per-layer metric that exist only as
    added files (and entries of BENCHMARK.json) run with no edit."""
    conf = json.loads((bench / 'configs' / 'pointpillar.json').read_text())
    conf['name'] = 'pointpillar_copy'
    (bench / 'configs' / 'pointpillar_copy.json').write_text(
        json.dumps(conf))
    work = json.loads((bench / 'workloads' /
                       'pointpillar.detect.b8.json').read_text())
    work['config'] = 'pointpillar_copy'
    (bench / 'workloads' / 'pointpillar_copy.detect.b8.json').write_text(
        json.dumps(work))
    (bench / 'metrics' / 'batches_traced.detect.py').write_text(
        "UNIT = 'batches'\n\n\ndef read(summary):\n"
        "    return float(summary['batches'])\n")
    path = bench.parent / 'BENCHMARK.json'
    b = json.loads(path.read_text())
    cell = 'pointpillar_copy.detect.b8'
    b['workloads'].append({'name': cell, 'config': 'pointpillar_copy',
                           'traffic': 'detect.b8', 'chips': 1, 'why': 'x'})
    for m in b['end_to_end']:
        if 'workloads' in m and 'pointpillar.detect.b8' in m['workloads']:
            m['workloads'].append(cell)
    b['per_layer'].append({'name': 'batches_traced.detect', 'unit':
                           'batches', 'better': 'higher', 'source':
                           'program_counter', 'layer': 'entry', 'moves':
                           'frames_per_s', 'workloads': [cell]})
    path.write_text(json.dumps(b))
    out = run_cell(cell)
    assert set(out['metrics']) == {'setup_s', 'frames_per_s',
                                   'batch_p95_ms'}
    assert out['correct']
    out = run_cell(cell, trace=1)
    assert out['metrics']['batches_traced.detect']['value'] == 1.0
    assert out['correct']


def test_no_jax_in_a_run(bench):
    """A run loads no module whose top-level name is jax, jaxlib, flax or
    pcdet_tpu; pcdet_tpu_torch is not pcdet_tpu."""
    run_cell('second.train.b8')
    assert 'pcdet_tpu_torch' in sys.modules
    assert run.forbidden_modules() == []
    sys.modules['pcdet_tpu'] = type(sys)('pcdet_tpu')
    try:
        assert run.forbidden_modules() == ['pcdet_tpu']
    finally:
        del sys.modules['pcdet_tpu']


def test_no_result_when_the_check_loads_jax(bench, monkeypatch, capsys):
    """The look for JAX comes after the reference's check: a check that
    loads a module named pcdet_tpu leaves the run with no result line."""
    from benchmark.entries import detect
    original = detect.check

    def loading(st, ctx, record):
        sys.modules['pcdet_tpu'] = type(sys)('pcdet_tpu')
        return original(st, ctx, record)
    monkeypatch.setattr(detect, 'check', loading)
    try:
        with pytest.raises(SystemExit, match='pcdet_tpu'):
            run_cell('pointpillar.detect.b8')
    finally:
        sys.modules.pop('pcdet_tpu', None)
    assert '{' not in capsys.readouterr().out


def test_no_jax_in_a_fresh_process(bench):
    """The same in a process of its own, where nothing else imported."""
    import subprocess
    code = ('import sys; sys.path.insert(0, %r); '
            'from benchmark.harness import common; import pathlib; '
            'common.ROOT = pathlib.Path(%r); from benchmark import run; '
            'run.main(["--workload", "pointpillar.detect.b8", "--seed", "5", '
            '"--seconds", "0.2"], device="cpu"); '
            'print("LOADED", sorted({m.split(".")[0] for m in sys.modules}))'
            % (str(tiny.BENCH.parent), str(bench)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [x for x in out.stdout.splitlines() if x.startswith('LOADED')][0]
    loaded = eval(line[len('LOADED '):])
    assert not set(loaded) & {'jax', 'jaxlib', 'flax', 'pcdet_tpu'}
    assert 'pcdet_tpu_torch' in loaded


def test_result_line_and_checks(bench, capsys):
    out = run_cell('second.train.b8')
    lines = capsys.readouterr()
    last = json.loads(lines.out.strip().splitlines()[-1])
    assert list(last)[-1] == 'checks'
    assert set(last['checks']) == {'loss_gap', 'grad_gap', 'grad_err',
                                   'change_gap'}
    assert 'check loss_gap' in lines.err
    assert out['correct'] and out['metrics']['samples_per_s']['value'] > 0


def test_rule_counts_by_hand():
    """Two sites side by side in x: a 3x3x3 subm conv finds 4 (output,
    tap) pairs; a stride-2 conv over them makes one or two outputs."""
    coords = torch.tensor([[0, 1, 2, 2], [0, 1, 2, 3]])
    level = sparse.Level(coords, torch.ones(2, 1), (4, 6, 6), 1)
    work = []
    sparse.subm_conv(level, torch.zeros(3, 3, 3, 1, 1), identity, work, 's')
    assert (work[0]['found'], work[0]['rows_read'], work[0]['n_out']) == (
        4, 2, 2)
    out, dropped = sparse.strided_conv(level, torch.ones(3, 3, 3, 1, 1),
                                       (2, 2, 2), (1, 1, 1), 10, identity,
                                       work, 'c')
    # output o meets input i through tap t where i = 2 o - 1 + t
    expect = set()
    for z, y, x in [(1, 2, 2), (1, 2, 3)]:
        for t in np.ndindex(3, 3, 3):
            o = [(c + 1 - tt) for c, tt in zip((z, y, x), t)]
            if all(v % 2 == 0 and 0 <= v // 2 < s for v, s in
                   zip(o, (2, 3, 3))):
                expect.add(tuple(v // 2 for v in o))
    assert {tuple(c) for c in out.coords[:, 1:].tolist()} == expect
    assert dropped == [0]
    pairs = sum(1 for z, y, x in [(1, 2, 2), (1, 2, 3)]
                for t in np.ndindex(3, 3, 3)
                if all((c + 1 - tt) % 2 == 0 and 0 <= (c + 1 - tt) // 2 < s
                       for c, tt, s in zip((z, y, x), t, (2, 3, 3))))
    assert work[1]['found'] == pairs
    # every output sums the ones of its found taps
    assert float(out.feats.sum()) == pairs


def test_work_formulas_by_hand():
    ops, nbytes = roofline.gather_work(16, 32, 27, 1000, 300, 200,
                                       'bfloat16')
    assert ops == 2 * 16 * 32 * 1000
    assert nbytes == 300 * 16 * 2 + 200 * 27 * 4 + 27 * 16 * 32 * 2 \
        + 200 * 32 * 4
    least = roofline.bound_s(ops, nbytes, 'bfloat16')
    assert least == max(ops / 989e12, nbytes / 3.35e12)
    ops, nbytes = roofline.dw_work(16, 32, 27, 1000, 300, 200)
    assert nbytes == 300 * 16 * 4 + 200 * (32 * 4 + 27 * 4) + 27 * 16 * 32 * 4


def test_rpn_ops_by_hand():
    conf = json.loads((tiny.BENCH / 'configs' / 'second.json').read_text())
    cfg = tiny.tiny_model(conf['model'])
    conv, heads = flops.rpn_ops(cfg, 128, (16, 16), 2)
    # block 0: stride 1, 16 x 16: 128->32 and one 32->32 conv, deconv 1x1
    b0 = 2 * 128 * 32 * 9 * 256 + 2 * 32 * 32 * 9 * 256 + 2 * 32 * 32 * 256
    # block 1: stride 2, 8 x 8: 32->64, 64->64, deconv 2x2 to 32
    b1 = (2 * 32 * 64 * 9 * 64 + 2 * 64 * 64 * 9 * 64
          + 2 * 64 * 32 * 4 * 64)
    assert conv == 2 * (b0 + b1)
    width = 6 * (7 + 3 + 2)
    assert heads == 2 * 2 * 64 * width * 256


def test_bench_json_contract():
    """BENCHMARK.json's cells and metrics name files that exist."""
    b = json.loads((tiny.BENCH.parent / 'BENCHMARK.json').read_text())
    for c in b['configs']:
        assert (tiny.BENCH.parent / c['file']).is_file()
    for w in b['workloads']:
        work = common.load_json('workloads', w['name'])
        assert work['config'] == w['config']
        assert work['chips'] == w['chips']
        assert set(work['limits'])
    for m in b['per_layer']:
        assert (tiny.BENCH / 'metrics' / (m['name'] + '.py')).is_file()
    assert any(m['name'] == 'setup_s' for m in b['end_to_end'])


def test_tiny_copy_is_separate(bench):
    assert bench != tiny.BENCH
    shutil.rmtree(bench / 'metrics')
    assert (tiny.BENCH / 'metrics').is_dir()
