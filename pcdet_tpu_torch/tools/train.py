"""Train CLI of the port.

The argparse surface and output layout of `tools/train.py` (the
reference's tools/train.py): output/<TAG>/<extra_tag>/{ckpt, log_train_*.txt}
under `cfg.ROOT_DIR`.  A run resumes from `--ckpt` or the latest checkpoint
of its ckpt directory; `--pretrained_model` loads what fits of a `.pth`
(the port's or a reference-keyed one).  The data comes from
`datasets.build_dataloader` (host voxelizer, augmentation, anchor targets,
and SECOND's books in the loader's `batch_transform`), the steps run on
`--device` (default cuda):

    python -m pcdet_tpu_torch.tools.train \
        --cfg_file tools/cfgs/pointpillar.yaml --batch_size 2 --epochs 80

One card holds one BatchNorm group, which is what `--sync_bn` asks for,
so the flag changes nothing.  Several hosts (`--multi_host`) and the
tensorboard / wandb mirrors are not ported.
"""
import argparse
import datetime
from pathlib import Path

import torch

from ..config import cfg_from_list, cfg_from_yaml_file, cfg_preprocess
from ..config import log_config_to_file
from ..datasets import build_dataloader
from ..ops import host_books
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
                        help='BatchNorm statistics over the whole batch: '
                             'what one card does')
    parser.add_argument('--multi_host', action='store_true', default=False)
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
    if args.multi_host:
        raise NotImplementedError(
            '--multi_host: training across hosts (torch DDP) is not ported '
            'yet, ROADMAP.md queue 1 item 6')
    if args.fix_random_seed:
        common.set_random_seed(666)

    output_dir = Path(cfg.ROOT_DIR) / 'output' / cfg.TAG / args.extra_tag
    ckpt_dir = output_dir / 'ckpt'
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    log_file = output_dir / ('log_train_%s.txt' % datetime.datetime.now()
                             .strftime('%Y%m%d-%H%M%S'))
    logger = common.create_logger(str(log_file))
    logger.info('**********************Start logging**********************')
    for key, val in vars(args).items():
        logger.info('{:16} {}'.format(key, val))
    log_config_to_file(cfg, logger=logger)

    dataset, train_loader = build_dataloader(
        cfg, args.batch_size, training=True, logger=logger,
        num_workers=args.workers, seed=666 if args.fix_random_seed else 0,
        worker_mode=args.worker_mode)
    frozen = tuple(str(p) for p in cfg.MODEL.TRAIN.get(
        'FREEZE_PARAM_PREFIXES', []))
    if frozen:
        logger.info('Freezing param prefixes: %s' % (frozen,))
    trainer = build_trainer(cfg, torch.device(args.device), seed=0,
                            iters_each_epoch=max(len(train_loader), 1),
                            epochs=args.epochs, frozen_prefixes=frozen)
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
    logger.info('device: %s, %d samples, %d iterations an epoch' % (
        trainer.device, len(dataset), len(train_loader)))

    logger.info('**********************Start training**********************')
    train_model(trainer, train_loader, total_epochs=args.epochs,
                start_epoch=start_epoch, ckpt_save_dir=str(ckpt_dir),
                ckpt_save_interval=args.ckpt_save_interval,
                max_ckpt_save_num=args.max_ckpt_save_num, logger=logger,
                log_interval=args.log_interval)
    logger.info('**********************End training**********************')
    return {'output_dir': output_dir, 'ckpt_dir': ckpt_dir,
            'log_file': log_file, 'trainer': trainer,
            'start_epoch': start_epoch}


if __name__ == '__main__':
    main()
