"""Train CLI of the port.

The argparse surface and output layout of `tools/train.py` (the
reference's tools/train.py): output/<TAG>/<extra_tag>/{ckpt, tensorboard,
log_train_*.txt} under `cfg.ROOT_DIR`.  A run resumes from `--ckpt` or the latest checkpoint
of its ckpt directory; `--pretrained_model` loads what fits of a `.pth`
(the port's or a reference-keyed one).  The data comes from
`datasets.build_dataloader` (host voxelizer, augmentation, anchor targets,
Part-A²'s per-voxel targets, and the sparse models' books in the loader's
`batch_transform`), the steps run on `--device` (default cuda):

    python -m pcdet_tpu_torch.tools.train \
        --cfg_file tools/cfgs/pointpillar.yaml --batch_size 2 --epochs 80

The fork's flags switch on its paths, as `--set USE_PSEUDOLIDAR True MODE
3dobjdet+bev` does: the step voxelizes the loader's points again on the
device, and PointPillar trains its BEV segmentation head on the loader's
masks.  The parameters to freeze come from `experiments.
training_before_epoch` (FREEZE_PARAM_PREFIXES, and `seg_model` under
INJECT_SEMANTICS without TRAIN_SEMANTIC_NETWORK).  The tb scalars go to a
tensorboardX `SummaryWriter` under output_dir/tensorboard where that
package imports, and to wandb where a run is open.

Data-parallel training (`--multi_host`): one process a card, launched by
torchrun, each joining the process group its environment describes
(`parallel.ddp.init_from_env`: NCCL on cuda:LOCAL_RANK, gloo with
`--device cpu`).  `--batch_size` is the global batch:
each of the W ranks loads `batch_size / W` samples of its own shard, and
the ranks sum their gradients.  By default each rank keeps its own
BatchNorm statistics (the reference's per-GPU BN); `--sync_bn` takes them
over every rank's batch, and changes nothing on one process.  Rank 0
logs, writes the tensorboard log and the checkpoints:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m pcdet_tpu_torch.tools.train --multi_host \
        --cfg_file tools/cfgs/second.yaml --batch_size 8 --epochs 80
"""
import argparse
import datetime
from pathlib import Path

import torch

from ..config import cfg_from_list, cfg_from_yaml_file, cfg_preprocess
from ..config import log_config_to_file
from ..datasets import build_dataloader
from ..experiments import training_before_epoch
from ..ops import host_books
from ..parallel import ddp
from ..train.checkpoint import (latest_checkpoint, load_params_partial,
                                restore_train_state)
from ..train.train_loop import train_model
from ..train.trainer import build_trainer
from ..utils import common


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description='pcdet_tpu_torch trainer')
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--batch_size', type=int, default=4)
    parser.add_argument('--epochs', type=int, default=80)
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--worker_mode', choices=['thread', 'process'],
                        default='thread',
                        help='process = a fork pool (batches are '
                             'bit-identical across modes)')
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--pretrained_model', type=str, default=None)
    parser.add_argument('--ckpt_save_interval', type=int, default=2)
    parser.add_argument('--max_ckpt_save_num', type=int, default=30)
    parser.add_argument('--fix_random_seed', action='store_true',
                        default=False)
    parser.add_argument('--sync_bn', action='store_true', default=False,
                        help='BatchNorm statistics over every rank\'s batch '
                             '(default: each rank\'s own)')
    parser.add_argument('--multi_host', action='store_true', default=False,
                        help='join the process group of torchrun\'s '
                             'environment (one process a card)')
    parser.add_argument('--device', type=str, default='cuda')
    parser.add_argument('--log_interval', type=int, default=50)
    parser.add_argument('--set', dest='set_cfgs', default=None,
                        nargs=argparse.REMAINDER,
                        help='set extra config keys')
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
        cfg_preprocess(cfg)
    return args, cfg


def main(argv=None):
    """Train; return {'output_dir', 'ckpt_dir', 'log_file', 'trainer',
    'start_epoch'}."""
    args, cfg = parse_config(argv)
    group, device = None, torch.device(args.device)
    if args.multi_host:
        group, device = ddp.init_from_env(device.type)
    try:
        return _train(args, cfg, group, device)
    finally:
        if args.multi_host:
            ddp.shutdown()


def _train(args, cfg, group, device):
    rank, world = ddp.rank(group), ddp.world_size(group)
    if args.batch_size % world:
        raise ValueError('batch_size %d must divide over %d ranks'
                         % (args.batch_size, world))
    if args.fix_random_seed:
        common.set_random_seed(666)

    output_dir = Path(cfg.ROOT_DIR) / 'output' / cfg.TAG / args.extra_tag
    ckpt_dir = output_dir / 'ckpt'
    log_file = output_dir / ('log_train_%s.txt' % datetime.datetime.now()
                             .strftime('%Y%m%d-%H%M%S'))
    if rank == 0:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
    ddp.barrier(group)
    logger = common.create_logger(str(log_file) if rank == 0 else None,
                                  rank=rank)
    logger.info('**********************Start logging**********************')
    for key, val in vars(args).items():
        logger.info('{:16} {}'.format(key, val))
    log_config_to_file(cfg, logger=logger)

    dataset, train_loader = build_dataloader(
        cfg, args.batch_size // world, training=True, logger=logger,
        num_workers=args.workers, host_id=rank, num_hosts=world,
        seed=666 if args.fix_random_seed else 0,
        worker_mode=args.worker_mode)
    frozen = training_before_epoch(cfg)
    if frozen:
        logger.info('Freezing param prefixes: %s' % (frozen,))
    trainer = build_trainer(cfg, device, seed=0,
                            iters_each_epoch=max(len(train_loader), 1),
                            epochs=args.epochs, frozen_prefixes=frozen,
                            process_group=group, sync_bn=args.sync_bn)
    dataset.set_anchor_targets(trainer.model.anchor_targets)
    train_loader.batch_transform = host_books.make_batch_transform(
        trainer.model, training=True)

    if args.pretrained_model is not None:
        load_params_partial(args.pretrained_model, trainer.model.module,
                            logger=logger)
    start_epoch = 0
    ckpt_to_resume = args.ckpt or latest_checkpoint(str(ckpt_dir))
    if ckpt_to_resume:
        logger.info('Resuming from %s' % ckpt_to_resume)
        _, start_epoch = restore_train_state(ckpt_to_resume, trainer.state)
    logger.info('device: %s, rank %d of %d, %d samples, %d iterations an '
                'epoch of %d samples a rank' % (
                    trainer.device, rank, world, len(dataset),
                    len(train_loader), args.batch_size // world))

    tb_log = None
    if rank == 0:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            SummaryWriter = None
            logger.info('tensorboardX does not import: no tensorboard log')
        if SummaryWriter is not None:
            tb_log = SummaryWriter(log_dir=str(output_dir / 'tensorboard'))

    logger.info('**********************Start training**********************')
    train_model(trainer, train_loader, total_epochs=args.epochs,
                start_epoch=start_epoch, ckpt_save_dir=str(ckpt_dir),
                ckpt_save_interval=args.ckpt_save_interval,
                max_ckpt_save_num=args.max_ckpt_save_num, logger=logger,
                log_interval=args.log_interval, tb_log=tb_log)
    if tb_log is not None:
        tb_log.close()
    logger.info('**********************End training**********************')
    return {'output_dir': output_dir, 'ckpt_dir': ckpt_dir,
            'log_file': log_file, 'trainer': trainer,
            'start_epoch': start_epoch}


if __name__ == '__main__':
    main()
