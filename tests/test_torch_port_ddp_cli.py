"""The train CLI's data-parallel launch on the CPU: `python -m
torch.distributed.run --standalone --nproc_per_node 2 -m
pcdet_tpu_torch.tools.train --multi_host --device cpu` (two gloo ranks) on
the fabricated KITTI tree (`kitti_tree.make_tree`, 4 train frames) at the
tiny PointPillar widths of `tests/test_torch_port_cli.py`, global batch 2
(one sample a rank), 2 epochs:

- it trains: both ranks take 2 steps an epoch (their shards are equal),
  the logged losses are finite;
- one log file and one checkpoint an epoch, written by rank 0 only, and
  the checkpoint's step count is the ranks' (2 an epoch);
- a second launch with 3 epochs resumes from epoch 2's checkpoint and
  writes epoch 3's;
- `--sync_bn` in one process (no group) changes nothing: its checkpoint
  equals the one without it, bit for bit.
"""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from kitti_tree import make_tree
from pcdet_tpu_torch.tools import create_data, train
from pcdet_tpu_torch.weights import load_checkpoint
from test_torch_port_cli import _cfg, _plain

REPO = Path(__file__).resolve().parent.parent
ARGS = ['--device', 'cpu', '--batch_size', '2', '--workers', '0',
        '--ckpt_save_interval', '1', '--log_interval', '1']


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp('ddp_cli')
    root = str(base / 'kitti')
    make_tree(root)
    cfg = _cfg(root, base / 'out')
    plain = _plain(cfg)
    plain.pop('TAG')
    cfg_file = base / 'tiny_kitti.yaml'
    cfg_file.write_text(yaml.safe_dump(plain))
    create_data.main(['kitti', '--cfg_file', str(cfg_file), '--workers',
                      '2'])
    return {'cfg_file': str(cfg_file),
            'out': base / 'out' / 'output' / 'tiny_kitti'}


def _torchrun(setup, epochs, tag):
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                        'MASTER_PORT')}
    env['OMP_NUM_THREADS'] = '1'
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node', '2', '-m', 'pcdet_tpu_torch.tools.train',
           '--multi_host', '--cfg_file', setup['cfg_file'], '--epochs',
           str(epochs), '--extra_tag', tag] + ARGS
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc


@pytest.fixture(scope='module')
def launched(setup):
    _torchrun(setup, 2, 'ddp')
    out = setup['out'] / 'ddp'
    logs = sorted(out.glob('log_train_*.txt'))
    first = {'logs': logs, 'text': logs[0].read_text(),
             'ckpts': sorted(os.listdir(out / 'ckpt'))}
    _torchrun(setup, 3, 'ddp')
    return out, first


def test_two_ranks_train_and_rank0_writes(launched):
    out, first = launched
    assert len(first['logs']) == 1
    text = first['text']
    assert 'rank 0 of 2' in text and '2 iterations an epoch' in text
    losses = [float(x) for x in re.findall(r' loss ([-0-9.naninf]+) lr',
                                           text)]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert first['ckpts'] == ['checkpoint_epoch_1.pth',
                              'checkpoint_epoch_2.pth']
    payload = load_checkpoint(str(out / 'ckpt' / 'checkpoint_epoch_2.pth'))
    assert payload['epoch'] == 2 and payload['it'] == 4
    assert payload['optimizer_state']['count'] == 4


def test_a_second_launch_resumes(launched):
    out, _ = launched
    logs = sorted(out.glob('log_train_*.txt'))
    assert len(logs) == 2
    text = logs[-1].read_text()
    assert 'Resuming from' in text and 'checkpoint_epoch_2.pth' in text
    assert 'epoch 2 iter 5 ' in text and 'epoch 1 ' not in text
    payload = load_checkpoint(str(out / 'ckpt' / 'checkpoint_epoch_3.pth'))
    assert payload['epoch'] == 3 and payload['it'] == 6


def test_sync_bn_on_one_process_changes_nothing(setup):
    sds = []
    for tag, extra in (('plain', []), ('sync', ['--sync_bn'])):
        train.main(['--cfg_file', setup['cfg_file'], '--epochs', '1',
                    '--extra_tag', tag] + ARGS + extra)
        sds.append(load_checkpoint(str(
            setup['out'] / tag / 'ckpt' / 'checkpoint_epoch_1.pth')))
    a, b = sds
    assert sorted(a['model_state']) == sorted(b['model_state'])
    for k, v in a['model_state'].items():
        assert torch.equal(v, b['model_state'][k]), k
    for slot, d in a['optimizer_state']['state'].items():
        for k, v in d.items():
            assert torch.equal(v, b['optimizer_state']['state'][slot][k]), k
