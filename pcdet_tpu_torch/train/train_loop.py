"""The epoch loop.

Twin of `pcdet_tpu.train.train_loop.train_model` (the reference's
tools/train_utils/train_utils.py train_model / train_one_epoch): per epoch
`set_epoch` and the `before_epoch` hook; per batch its upload (a data
loader's dict through `Trainer.upload`, `TrainScans`' raw scans through
`Trainer.make_batch`), `Trainer.step` and the `after_iter` hook;
every `ckpt_save_interval` epochs a checkpoint, pruned to
`max_ckpt_save_num`.  The step count lives on the host (`TrainState.step`),
and the tb values are read from the card only every `log_interval` steps,
so the host prepares the next batch while the card runs the step.  A
logged step's line carries its `overflow/*` counts, and a nonzero one is
also logged as a `CAP OVERFLOW` warning: a static cap truncated real
data.  The wandb mirror and the tensorboard writer of `pcdet_tpu` are not
ported.
"""
import time

import torch

from .checkpoint import save_checkpoint


def train_model(trainer, train_loader, total_epochs, start_epoch=0,
                ckpt_save_dir=None, ckpt_save_interval=1,
                max_ckpt_save_num=30, logger=None, log_interval=50,
                hooks=None):
    """Train `trainer` (`trainer.Trainer`) from `start_epoch` up to
    `total_epochs`; return its `TrainState`.

    :param train_loader: iterable with `set_epoch(epoch)` of collated dict
        batches (`datasets.loader.DataLoader`) or of numpy (points, mask,
        gt_boxes) batches (`trainer.TrainScans`)
    :param hooks: optional object with `before_epoch(epoch)` /
        `after_iter(step, tb_dict)` callbacks (the fork's experiments
        hooks; tb holds tensors on the card)
    """
    state = trainer.state
    dev = trainer.device
    for epoch in range(start_epoch, total_epochs):
        train_loader.set_epoch(epoch)
        if hooks is not None and hasattr(hooks, 'before_epoch'):
            hooks.before_epoch(epoch)
        t_epoch = time.time()
        n_iters = 0
        for item in train_loader:
            if isinstance(item, dict):
                batch = trainer.upload(item)
            else:
                points, mask, gt_boxes = item
                batch = trainer.make_batch(
                    torch.as_tensor(points, device=dev),
                    torch.as_tensor(mask, device=dev), gt_boxes)
            tb = trainer.step(batch)
            n_iters += 1
            if hooks is not None and hasattr(hooks, 'after_iter'):
                hooks.after_iter(state.step, tb)
            if state.step % log_interval == 0 and logger is not None:
                tb_host = {k: float(v) for k, v in tb.items()}
                logger.info('epoch %d iter %d loss %.4f lr %.6f%s' % (
                    epoch, state.step, tb_host['loss'],
                    trainer.lr_schedule(state.step), ''.join(
                        ' %s %d' % (k, int(v)) for k, v in tb_host.items()
                        if k.startswith('overflow/'))))
                for k, v in tb_host.items():
                    if k.startswith('overflow/') and v > 0:
                        logger.warning(
                            'CAP OVERFLOW %s: %d active sites dropped this '
                            'step — raise the corresponding cap (level_caps '
                            '/ MAX_NUMBER_OF_VOXELS)' % (k, int(v)))
        if logger is not None:
            logger.info('epoch %d done in %.1fs (%d iters)'
                        % (epoch, time.time() - t_epoch, n_iters))
        trained_epoch = epoch + 1
        if (ckpt_save_dir is not None
                and trained_epoch % ckpt_save_interval == 0):
            save_checkpoint(state, ckpt_save_dir, trained_epoch,
                            max_ckpt_save_num=max_ckpt_save_num)
    return state
