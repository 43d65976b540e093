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
logged step's line carries its `overflow/*` counts and the BEV head's
`bev_loss` / `miou`, and a nonzero overflow is also logged as a `CAP
OVERFLOW` warning: a static cap truncated real data.  The same logged
steps' tb scalars go to `tb_log` (a tensorboardX writer: `train_<key>`
and `learning_rate`) and to wandb where the package imports and a run is
open (`pcdet_tpu`'s mirrors); a missing package means no mirror.

Under the trainer's process group every rank runs the loop on its own
shard of the loader (as many batches on each rank); the logged steps' tb
values are summed over the ranks (`ddp.reduce_tb`, on every rank at the
same steps), rank 0 logs and writes the mirrors, and every rank enters
`save_checkpoint`, which rank 0 writes while the others wait.
"""
import time

import torch

from ..parallel import ddp
from .checkpoint import save_checkpoint


def _wandb_log(scalars, step):
    """The wandb mirror: used only where the package imports and a run was
    opened (the fork hard-wires wandb)."""
    try:
        import wandb
    except ImportError:
        return
    if wandb.run is not None:
        wandb.log(scalars, step=step)


def train_model(trainer, train_loader, total_epochs, start_epoch=0,
                ckpt_save_dir=None, ckpt_save_interval=1,
                max_ckpt_save_num=30, logger=None, log_interval=50,
                hooks=None, tb_log=None):
    """Train `trainer` (`trainer.Trainer`) from `start_epoch` up to
    `total_epochs`; return its `TrainState`.

    :param train_loader: iterable with `set_epoch(epoch)` of collated dict
        batches (`datasets.loader.DataLoader`) or of numpy (points, mask,
        gt_boxes) batches (`trainer.TrainScans`)
    :param hooks: optional object with `before_epoch(epoch)` /
        `after_iter(step, tb_dict)` callbacks (the fork's experiments
        hooks; tb holds tensors on the card)
    :param tb_log: optional tensorboardX `SummaryWriter` for the logged
        steps' scalars
    """
    state = trainer.state
    dev = trainer.device
    group = trainer.process_group
    if ddp.rank(group):
        logger = tb_log = None
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
            if state.step % log_interval:
                continue
            tb_host = {k: float(v)
                       for k, v in ddp.reduce_tb(tb, group).items()}
            lr = trainer.lr_schedule(state.step)
            if logger is not None:
                logger.info('epoch %d iter %d loss %.4f lr %.6f%s%s' % (
                    epoch, state.step, tb_host['loss'], lr, ''.join(
                        ' %s %.4f' % (k, tb_host[k])
                        for k in ('bev_loss', 'miou') if k in tb_host),
                    ''.join(' %s %d' % (k, int(v))
                            for k, v in tb_host.items()
                            if k.startswith('overflow/'))))
                for k, v in tb_host.items():
                    if k.startswith('overflow/') and v > 0:
                        logger.warning(
                            'CAP OVERFLOW %s: %d active sites dropped this '
                            'step — raise the corresponding cap (level_caps '
                            '/ MAX_NUMBER_OF_VOXELS)' % (k, int(v)))
            if tb_log is not None:
                for k, v in tb_host.items():
                    tb_log.add_scalar('train_' + k, v, state.step)
                tb_log.add_scalar('learning_rate', lr, state.step)
            if not ddp.rank(group):
                _wandb_log(tb_host, state.step)
        if logger is not None:
            logger.info('epoch %d done in %.1fs (%d iters)'
                        % (epoch, time.time() - t_epoch, n_iters))
        trained_epoch = epoch + 1
        if (ckpt_save_dir is not None
                and trained_epoch % ckpt_save_interval == 0):
            save_checkpoint(state, ckpt_save_dir, trained_epoch,
                            max_ckpt_save_num=max_ckpt_save_num)
    return state
