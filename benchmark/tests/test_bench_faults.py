"""A run with the timed path broken underneath comes out not correct, and
so does the control (the reference in the next lower precision in the
program's place).  The look for a card is skipped; the program runs its
plain paths on the CPU at tiny sizes, the limits are the cells' own."""
import pytest
import torch

from benchmark import control, run
from benchmark.harness import common
from benchmark.tests import tiny

# the detect cells of BENCHMARK.json
DETECT_CELLS = ['pointpillar.detect.b8']

@pytest.fixture
def bench(tmp_path, monkeypatch):
    root = tiny.tiny_bench(tmp_path)
    monkeypatch.setattr(common, 'ROOT', root)
    return root


def run_cell(cell):
    return run.main(['--workload', cell, '--seed', '3000000003',
                     '--seconds', '0.5', '--trace', '0'], device='cpu')


@pytest.mark.parametrize('cell', DETECT_CELLS)
def test_sound_detect_is_correct(bench, cell):
    assert run_cell(cell)['correct']


def test_a_cell_without_limits_is_refused(bench, capsys):
    """A workload that sets no correctness limit (SECOND's detect loop, whose
    limits no readings set yet) gives no result: nothing would be compared."""
    import json
    work = json.loads((bench / 'workloads' /
                       'pointpillar.detect.b8.json').read_text())
    work['config'] = 'second'
    del work['limits']
    (bench / 'workloads' / 'second.detect.b8.json').write_text(
        json.dumps(work))
    with pytest.raises(SystemExit, match='no correctness limits'):
        run_cell('second.detect.b8')
    assert '{' not in capsys.readouterr().out


def _wrap_detect(monkeypatch, change):
    from pcdet_tpu_torch import detect
    original = detect.Detector.detect

    def broken(self, points, point_mask):
        preds = dict(original(self, points, point_mask))
        change(preds)
        return preds
    monkeypatch.setattr(detect.Detector, 'detect', broken)


@pytest.mark.parametrize('cell', DETECT_CELLS)
def test_half_the_batch_left_out(bench, monkeypatch, cell):
    def drop(preds):
        half = preds['num'].shape[0] // 2
        preds['num'] = preds['num'].clone()
        preds['num'][half:] = 0
    _wrap_detect(monkeypatch, drop)
    out = run_cell(cell)
    assert not out['correct']
    assert out['checks']['set_gap']['value'] > out['checks']['set_gap'][
        'limit']


@pytest.mark.parametrize('cell', DETECT_CELLS)
def test_an_answer_altered(bench, monkeypatch, cell):
    def move(preds):
        preds['boxes'] = preds['boxes'].clone()
        preds['boxes'][0, 0, :2] += 20.0
    _wrap_detect(monkeypatch, move)
    out = run_cell(cell)
    assert not out['correct']
    assert out['checks']['det_gap']['value'] > out['checks']['det_gap'][
        'limit']


def test_sound_train_is_correct(bench):
    assert run_cell('second.train.b8')['correct']


def test_a_step_that_leaves_the_state(bench, monkeypatch):
    from pcdet_tpu_torch.train import train_state

    def frozen(self, batch, inputs=()):
        loss, tb, _ = self.loss_and_grads(batch, inputs)
        tb['loss'] = loss
        return tb
    monkeypatch.setattr(train_state.TrainState, 'train_step', frozen)
    out = run_cell('second.train.b8')
    assert not out['correct']
    assert out['checks']['change_gap']['value'] == pytest.approx(1.0)


def test_half_of_each_batch_left_out(bench, monkeypatch):
    from pcdet_tpu_torch.train import trainer
    original = trainer.Trainer.make_batch

    def half(self, points, point_mask, gt_boxes, point_feature_fn=None):
        h = points.shape[0] // 2
        return original(self, points[:h], point_mask[:h], gt_boxes[:h],
                        point_feature_fn)
    monkeypatch.setattr(trainer.Trainer, 'make_batch', half)
    assert not run_cell('second.train.b8')['correct']


@pytest.mark.parametrize('cell', DETECT_CELLS + ['second.train.b8'])
def test_control_fails(bench, cell):
    """The control fails one of the cell's numbers, on three seeds."""
    limits = common.load_json('workloads', cell)['limits']
    rows = control.main(['--workload', cell, '--what', 'control',
                         '--seeds', '11,12,13'], device='cpu')
    for row in rows:
        assert any(row['values'][k] > lim for k, lim in limits.items()), row
