"""The port's CLI pair on the CPU, on the fabricated KITTI tree
(`kitti_tree.make_tree`) at the tiny PointPillar widths on a 128 x 128
grid:

- one `Trainer.step` from a loader batch (`Trainer.upload`: the host
  voxelizer's voxels and the anchor targets, uploaded once) against
  pcdet_tpu's `make_train_step` on the same batch and the same random
  flax variables, at PR 12's tolerances: loss and every tb term to 1e-5
  relative (`tests/test_torch_port_pointpillar_train.py`), the loss over
  3 steps to 1e-4 relative; the port also reports `overflow/voxelizer`,
  which pcdet_tpu's device batch drops;
- `create_data` -> the train CLI (`--device cpu`, 2 epochs, one checkpoint
  an epoch) -> the test CLI in a subprocess: its logged AP string equals
  the evaluator run again on its own result.pkl;
- a resumed run continues at the saved epoch and writes the checkpoint
  the uninterrupted run wrote, bit for bit;
- `--eval_all --max_waiting_mins 0` evaluates both checkpoints once and
  lists them in eval_list_val.txt;
- SECOND (tiny widths): the loader's books equal the model's own
  `build_books` decoded by `upload_books`, a batch without books raises;
  a step on them; `eval_one_epoch` over the eval loader
  with its books;
- `--ckpt` takes a bare reference-keyed state_dict (`weights.
  state_dict_from_flax`'s layout), `--multi_host` raises.
"""
import copy
import os
import pickle
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from kitti_tree import kitti_cfg, make_tree
from tiny_config import tiny_second_cfg

from pcdet_tpu.models.pointpillar import PointPillar as JaxPointPillar
from pcdet_tpu.train import optimization as jax_opt
from pcdet_tpu.train import train_state as jax_train
from pcdet_tpu_torch import detect
from pcdet_tpu_torch.datasets import build_dataloader
from pcdet_tpu_torch.datasets.kitti import kitti_eval_cli
from pcdet_tpu_torch.ops import host_books
from pcdet_tpu_torch.tools import create_data, test, train
from pcdet_tpu_torch.train import train_state
from pcdet_tpu_torch.train.eval_loop import eval_one_epoch
from pcdet_tpu_torch.train.trainer import build_trainer
from pcdet_tpu_torch.weights import load_checkpoint, state_dict_from_flax

from test_torch_port_pointpillar_train import _random_variables

REPO = Path(__file__).resolve().parent.parent
CLASSES = ['Car', 'Pedestrian', 'Cyclist']
TOTAL_STEPS = 10


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _cfg(root, out_root):
    cfg = kitti_cfg(root)
    cfg.ROOT_DIR = str(out_root)
    dc = cfg.DATA_CONFIG
    dc.DATA_DIR = root
    dc.POINT_CLOUD_RANGE = [0, -16, -3, 32, 16, 1]
    dc.VOXEL_GENERATOR.VOXEL_SIZE = [0.25, 0.25, 4]
    dc.TRAIN.INFO_PATH = [os.path.join(root, 'kitti_infos_train.pkl')]
    dc.TEST.INFO_PATH = [os.path.join(root, 'kitti_infos_val.pkl')]
    dc.AUGMENTATION.DB_SAMPLER.DB_INFO_PATH = [
        os.path.join(root, 'kitti_dbinfos_train.pkl')]
    cfg.MODEL.TEST.SCORE_THRESH = 0.0       # random weights score ~0.01
    return cfg


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """The tree, its config as a yaml file, create_data run on it."""
    base = tmp_path_factory.mktemp('cli')
    root = str(base / 'kitti')
    make_tree(root)
    cfg = _cfg(root, base / 'out')
    plain = _plain(cfg)
    plain.pop('TAG')
    cfg_file = base / 'tiny_kitti.yaml'
    cfg_file.write_text(yaml.safe_dump(plain))
    create_data.main(['kitti', '--cfg_file', str(cfg_file), '--workers',
                      '2'])
    return {'root': root, 'cfg': cfg, 'cfg_file': str(cfg_file),
            'out': base / 'out' / 'output' / 'tiny_kitti'}


TRAIN_ARGS = ['--device', 'cpu', '--batch_size', '2', '--epochs', '2',
              '--workers', '2', '--ckpt_save_interval', '1',
              '--log_interval', '1']


@pytest.fixture(scope='module')
def trained(setup):
    out = train.main(['--cfg_file', setup['cfg_file']] + TRAIN_ARGS)
    return out


def test_trainer_step_from_a_loader_batch_matches_make_train_step(setup):
    cfg = setup['cfg']
    ds, loader = build_dataloader(cfg, 2, training=True, num_workers=0)
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=TOTAL_STEPS)
    ds.set_anchor_targets(trainer.model.anchor_targets)
    loader.set_epoch(0)
    batch = next(iter(loader))
    jmodel = JaxPointPillar(cfg, ds.grid_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()
              if isinstance(v, np.ndarray) and v.dtype.kind in 'biufc'}
    template = jax.eval_shape(
        lambda: jmodel.init_variables(jax.random.PRNGKey(0), jbatch))
    variables = _random_variables(template, 1)
    layer_nums = cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']
    trainer.model.module.load_state_dict(state_dict_from_flax(
        variables, layer_nums))
    tbatch = trainer.upload(batch)
    assert tbatch['voxels'].shape == (2, 2000, 16, 4)
    for key in ('voxels', 'coordinates', 'box_cls_labels', 'voxel_overflow'):
        np.testing.assert_array_equal(tbatch[key].numpy(), batch[key])

    def loss_fn(params):
        ret, _ = jmodel.forward({'params': params,
                                 'batch_stats': variables['batch_stats']},
                                jbatch, train=True)
        return jmodel.loss(ret, jbatch)

    loss, tb = jax.jit(loss_fn)(variables['params'])
    got_loss, got_tb, _ = train_state.loss_and_grads(
        trainer.model, trainer.state.params, tbatch)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    # collate_batch keeps the per-sample numpy scalars `voxel_overflow` as a
    # list, which pcdet_tpu's device batch (numeric arrays only) drops; the
    # port uploads it as an array and reports it
    assert sorted(got_tb) == sorted(list(tb) + ['overflow/voxelizer'])
    assert int(got_tb['overflow/voxelizer']) == sum(batch['voxel_overflow'])
    for k, v in tb.items():
        np.testing.assert_allclose(float(got_tb[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)

    tx, _ = jax_opt.build_optimizer_and_schedule(
        cfg.MODEL.TRAIN.OPTIMIZATION, TOTAL_STEPS, 1)
    step = jax_train.make_train_step(jmodel, tx, donate=False)
    state = jax_train.create_train_state(variables, tx)
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=TOTAL_STEPS)
    trainer.model.module.load_state_dict(state_dict_from_flax(
        variables, layer_nums))
    want, got = [], []
    for _ in range(3):
        state, tb = step(state, jbatch)
        want.append(float(tb['loss']))
        got.append(float(trainer.step(tbatch)['loss']))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(set(want)) == 3


def _logged_result(log_file):
    """The AP string of the last evaluation a log holds: the record that
    starts 'Car AP@', up to the next record."""
    lines = Path(log_file).read_text().splitlines()
    stamp = re.compile(r'^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d+ ')
    starts = [i for i, l in enumerate(lines) if stamp.match(l)
              and 'INFO  Car AP@' in l]
    assert starts, 'no AP string in %s' % log_file
    i = starts[-1]
    out = [lines[i].split('INFO  ', 1)[1]]
    for line in lines[i + 1:]:
        if stamp.match(line):
            break
        out.append(line)
    return '\n'.join(out).strip()


def test_cli_round_trip(setup, trained):
    ckpt_dir = Path(trained['ckpt_dir'])
    assert sorted(os.listdir(ckpt_dir)) == ['checkpoint_epoch_1.pth',
                                            'checkpoint_epoch_2.pth']
    log = Path(trained['log_file']).read_text()
    losses = [float(x) for x in re.findall(r'iter \d+ loss ([\d.]+)', log)]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert len(re.findall(r'overflow/voxelizer \d+', log)) == 4
    ckpt = str(ckpt_dir / 'checkpoint_epoch_2.pth')
    proc = subprocess.run(
        [sys.executable, '-m', 'pcdet_tpu_torch.tools.test', '--cfg_file',
         setup['cfg_file'], '--device', 'cpu', '--batch_size', '2',
         '--workers', '2', '--extra_tag', 'subprocess', '--ckpt', ckpt],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    eval_root = setup['out'] / 'subprocess' / 'eval'
    with open(eval_root / 'epoch_2' / 'val' / 'result.pkl', 'rb') as f:
        det_annos = pickle.load(f)
    with open(setup['cfg'].DATA_CONFIG.TEST.INFO_PATH[0], 'rb') as f:
        gt_infos = pickle.load(f)
    assert len(det_annos) == 2 and sum(a['num_example']
                                       for a in det_annos) > 0
    again, _ = kitti_eval_cli.evaluation(det_annos, gt_infos, CLASSES)
    logs = list(eval_root.glob('log_eval_*.txt'))
    assert len(logs) == 1
    assert _logged_result(logs[0]) == again.strip()
    assert re.search(r'recall_rcnn_0.5: [\d.]+', logs[0].read_text())


def test_resume_continues_at_the_saved_epoch(setup, trained):
    ckpt_dir = Path(trained['ckpt_dir'])
    last = ckpt_dir / 'checkpoint_epoch_2.pth'
    want = load_checkpoint(str(last))
    shutil.move(str(last), str(ckpt_dir.parent / 'uninterrupted.pth'))
    try:
        out = train.main(['--cfg_file', setup['cfg_file'], '--extra_tag',
                          'default'] + TRAIN_ARGS)
        assert out['start_epoch'] == 1
        assert 'Resuming from %s' % (ckpt_dir / 'checkpoint_epoch_1.pth') \
            in Path(out['log_file']).read_text()
        got = load_checkpoint(str(last))
    finally:
        shutil.move(str(ckpt_dir.parent / 'uninterrupted.pth'), str(last))
    assert got['epoch'] == want['epoch'] == 2 and got['it'] == want['it'] == 4
    for part in ('model_state',):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), k
    opt_got, opt_want = got['optimizer_state'], want['optimizer_state']
    assert opt_got['count'] == opt_want['count']
    for slot, d in opt_want['state'].items():
        for k, v in d.items():
            assert torch.equal(opt_got['state'][slot][k], v), (slot, k)


def test_eval_all_evaluates_each_checkpoint_once(setup, trained):
    args = ['--cfg_file', setup['cfg_file'], '--device', 'cpu',
            '--batch_size', '2', '--workers', '0', '--extra_tag', 'default',
            '--eval_all', '--max_waiting_mins', '0']
    out = test.main(args)
    assert sorted(out['results']) == [1, 2]
    for epoch, (eval_dir, result) in out['results'].items():
        assert (eval_dir / 'result.pkl').exists()
        assert result['recall/gt'] == 2 and 'Car_3d_moderate' in result
    record = out['eval_root'] / 'eval_list_val.txt'
    assert record.read_text().split() == ['1', '2']
    assert test.main(args)['results'] == {}


def test_ckpt_takes_a_bare_reference_keyed_state_dict(setup, tmp_path):
    trainer = build_trainer(setup['cfg'], 'cpu', seed=5)
    sd = trainer.model.module.state_dict()
    path = tmp_path / 'reference.pth'
    torch.save(sd, path)
    out = test.main(['--cfg_file', setup['cfg_file'], '--device', 'cpu',
                     '--batch_size', '2', '--workers', '0', '--extra_tag',
                     'reference', '--ckpt', str(path)])
    got = out['detector'].model.module.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    assert list(out['results']) == ['no_number']


def _second_cfg(cfg):
    """The KITTI config at tiny SECOND widths (a 128 x 128 x 16 grid)."""
    cfg = copy.deepcopy(cfg)
    tiny = tiny_second_cfg(num_class=3)
    cfg.MODEL = copy.deepcopy(tiny.MODEL)
    cfg.MODEL.TEST.SCORE_THRESH = 0.0
    cfg.DATA_CONFIG.VOXEL_GENERATOR = copy.deepcopy(
        tiny.DATA_CONFIG.VOXEL_GENERATOR)
    for mode in ('TRAIN', 'TEST'):
        cfg.DATA_CONFIG[mode].MAX_NUMBER_OF_VOXELS = 3000
    return cfg


def test_second_trains_and_evaluates_on_the_loaders_books(setup):
    """SECOND's loader batch: the books of the loader's `batch_transform`
    equal the model's own `build_books`, decoded; `Trainer.upload` refuses
    a batch without them; a step
    on them, then `eval_one_epoch` over the eval loader with its books."""
    cfg = _second_cfg(setup['cfg'])
    ds, loader = build_dataloader(cfg, 2, training=True, num_workers=0)
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=2)
    ds.set_anchor_targets(trainer.model.anchor_targets)
    loader.batch_transform = host_books.make_batch_transform(trainer.model,
                                                             training=True)
    loader.set_epoch(0)
    batch = next(iter(loader))
    assert any(k.startswith('hb_') for k in batch)
    got = trainer.upload(batch)
    built = trainer.model.upload_books(
        trainer.model.build_books(batch['coordinates'], train=True),
        batch['coordinates'].shape[1], train=True)
    assert sorted(got['books']) == sorted(built)
    for key, book in got['books'].items():
        other = built[key]
        for a, b in zip(*((book, other) if isinstance(book, tuple)
                          else ((book,), (other,)))):
            assert torch.equal(a, b), key
    with pytest.raises(ValueError, match='hb_'):
        trainer.upload({k: v for k, v in batch.items()
                        if not k.startswith('hb_')})
    tb = trainer.step(got)
    assert np.isfinite(float(tb['loss'])) and 'overflow/conv2' in tb
    det = detect.build_detector(cfg, 'cpu', state_dict=
                                trainer.model.module.state_dict())
    eds, eloader = build_dataloader(cfg, 2, training=False, num_workers=0)
    eloader.batch_transform = host_books.make_batch_transform(
        det.model, training=False)
    result = eval_one_epoch(det, eloader, eds, cfg)
    assert result['recall/gt'] == 2
    assert all(np.isfinite(float(v)) for v in result.values())


def test_multi_host_is_not_ported(setup):
    with pytest.raises(NotImplementedError, match='queue 1 item 6'):
        train.main(['--cfg_file', setup['cfg_file'], '--multi_host'])
