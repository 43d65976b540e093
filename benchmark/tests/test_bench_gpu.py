"""On the card: each cell at its own size for a short window comes out
correct, and the control comes out not correct.

    python -m pytest -m gpu benchmark/tests/test_bench_gpu.py -q
"""
import json

import pytest

from benchmark import control, run
from benchmark.harness import common

CELLS = [w['name'] for w in json.loads(
    (common.BENCH_ROOT.parent / 'BENCHMARK.json').read_text())['workloads']]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the port\'s hand-written kernels')


@pytest.mark.gpu
@pytest.mark.parametrize('cell', CELLS)
def test_cell_is_correct(card, cell):
    out = run.main(['--workload', cell, '--seed', '3000000011',
                    '--seconds', '2', '--trace', '0'])
    assert out['correct'], out['checks']


@pytest.mark.gpu
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails(card, cell):
    limits = common.load_json('workloads', cell)['limits']
    row = control.main(['--workload', cell, '--what', 'control',
                        '--seeds', '3000000012'])[0]
    assert any(row['values'][k] > lim for k, lim in limits.items()), row
