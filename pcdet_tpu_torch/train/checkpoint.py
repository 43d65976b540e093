"""Checkpoints, `.pth` files with the reference's epoch-tagged names.

Twin of `pcdet_tpu.train.checkpoint` (the reference's train_utils.py
checkpoint_state / save_checkpoint and detector3d.py load_params_*):

- `save_checkpoint` writes `checkpoint_epoch_<N>.pth` with the reference's
  keys, `epoch`, `it`, `model_state` (the module's reference-keyed
  state_dict, so a reference `.pth` or `weights.state_dict_from_flax`'s
  output loads as it is), `optimizer_state`, `version`; it writes a
  temporary name first and renames it (`os.replace`), so a run killed
  mid-write leaves no file that `list_checkpoints` lists; then it prunes to
  `max_ckpt_save_num`, oldest first by mtime (ties by epoch);
- `latest_checkpoint` is the newest, `restore_train_state` resumes from a
  file (parameters, BN statistics, optimizer moments and counts, the step);
- `load_params_partial` loads what fits of a file's `model_state` and logs
  each entry it leaves as it was.

Tensors load onto the device of the state or module they go into.
"""
import os
import re

import torch

from ..weights import load_checkpoint, model_state

VERSION = 'pcdet_tpu_torch+0.1.0'
_NAME = re.compile(r'^checkpoint_epoch_(\d+)\.pth$')


def checkpoint_path(ckpt_dir, epoch):
    return os.path.join(os.path.abspath(ckpt_dir),
                        'checkpoint_epoch_%d.pth' % epoch)


def save_checkpoint(state, ckpt_dir, epoch, max_ckpt_save_num=None,
                    version=VERSION):
    """Write `state` (`train_state.TrainState`) after `epoch` epochs; return
    the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    sd = state.state_dict()
    payload = {'epoch': int(epoch), 'it': sd['it'],
               'model_state': sd['model_state'],
               'optimizer_state': sd['optimizer_state'], 'version': version}
    path = checkpoint_path(ckpt_dir, epoch)
    tmp = path + '.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if max_ckpt_save_num is not None:
        ckpts = list_checkpoints(ckpt_dir)
        while len(ckpts) > max_ckpt_save_num:
            os.remove(ckpts.pop(0))
    return path


def list_checkpoints(ckpt_dir):
    """The complete checkpoints of `ckpt_dir`, oldest first (mtime, then
    epoch); temporary files of an unfinished write are not among them."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = _NAME.match(name)
        if m:
            path = os.path.join(os.path.abspath(ckpt_dir), name)
            found.append((os.path.getmtime(path), int(m.group(1)), path))
    return [p for _, _, p in sorted(found)]


def latest_checkpoint(ckpt_dir):
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def restore_train_state(path, state):
    """Full resume (the reference's load_params_with_optimizer): copy the
    file's model, optimizer and step into `state`, in place.

    :return: (state, the epochs the file was saved after)
    """
    payload = load_checkpoint(path, state.model.device)
    state.load_state_dict(payload)
    return state, int(payload['epoch'])


def load_params_partial(path, module, logger=None):
    """Shape-tolerant load (the reference's load_params_from_file): each
    entry of `module.state_dict()` takes the file's `model_state` entry of
    the same name and shape (a bare state_dict is taken as one); any other
    keeps its value and is logged.

    :return: (the names not updated, the file's epoch (-1 where it has
        none), its it (0 where none))
    """
    payload = load_checkpoint(path, next(module.parameters()).device)
    disk = model_state(payload)
    own = module.state_dict()
    merged, skipped = {}, []
    for key, value in own.items():
        d = disk.get(key)
        if isinstance(d, torch.Tensor) and d.shape == value.shape:
            merged[key] = d.to(value.dtype)
        else:
            skipped.append(key)
            if logger is not None:
                logger.info('Not updated weight %s: %s'
                            % (key, tuple(value.shape)))
    module.load_state_dict(merged, strict=False)
    return skipped, int(payload.get('epoch', -1)), int(payload.get('it', 0))
