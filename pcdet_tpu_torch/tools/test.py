"""Eval CLI of the port: evaluate one checkpoint, or watch a checkpoint
directory and evaluate each one as it appears.

The argparse surface and output layout of `tools/test.py` (the reference's
tools/test.py): output/<TAG>/<extra_tag>/eval/{log_eval_*.txt,
epoch_<N>/<split>/result.pkl, eval_list_<split>.txt} under `cfg.ROOT_DIR`.
`--ckpt` takes the port's `.pth` or a reference-keyed one (what fits is
loaded, `train.checkpoint.load_params_partial`).  The data comes from
`datasets.build_dataloader` (host voxelizer; SECOND's books in the
loader), the detect, NMS and recall (kernel A) run on `--device` (default
cuda), the official KITTI AP on the host:

    python -m pcdet_tpu_torch.tools.test \
        --cfg_file tools/cfgs/pointpillar.yaml --batch_size 2 --ckpt PATH
    python -m pcdet_tpu_torch.tools.test \
        --cfg_file tools/cfgs/pointpillar.yaml --eval_all

`--eval_all` evaluates every checkpoint of the ckpt directory from
`--start_epoch` on that `eval_list_<split>.txt` does not list, then waits
for new ones until none has come for `--max_waiting_mins` (0: it does not
wait).
"""
import argparse
import datetime
import re
import time
from pathlib import Path

import torch

from ..config import cfg_from_list, cfg_from_yaml_file, cfg_preprocess
from ..datasets import build_dataloader
from ..detect import build_detector
from ..ops import host_books
from ..train.checkpoint import list_checkpoints, load_params_partial
from ..train.eval_loop import eval_one_epoch
from ..utils import common

WAIT_SECONDS = 30


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description='pcdet_tpu_torch evaluator')
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--batch_size', type=int, default=4)
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--worker_mode', choices=['thread', 'process'],
                        default='thread')
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--eval_all', action='store_true', default=False)
    parser.add_argument('--ckpt_dir', type=str, default=None)
    parser.add_argument('--max_waiting_mins', type=int, default=30)
    parser.add_argument('--start_epoch', type=int, default=0)
    parser.add_argument('--save_to_file', action='store_true', default=False)
    parser.add_argument('--device', type=str, default='cuda')
    parser.add_argument('--set', dest='set_cfgs', default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
        cfg_preprocess(cfg)
    return args, cfg


def epoch_from_path(path):
    nums = re.findall(r'checkpoint_epoch_(\d+)', str(path))
    return int(nums[-1]) if nums else 'no_number'


def main(argv=None):
    """Evaluate; return {'eval_root', 'log_file', 'detector', 'results':
    {epoch: (eval_dir, result dict)}}."""
    args, cfg = parse_config(argv)
    output_dir = Path(cfg.ROOT_DIR) / 'output' / cfg.TAG / args.extra_tag
    eval_root = output_dir / 'eval'
    eval_root.mkdir(parents=True, exist_ok=True)
    log_file = eval_root / ('log_eval_%s.txt' % datetime.datetime.now()
                            .strftime('%Y%m%d-%H%M%S'))
    logger = common.create_logger(str(log_file))
    for key, val in vars(args).items():
        logger.info('{:16} {}'.format(key, val))

    dataset, loader = build_dataloader(
        cfg, args.batch_size, training=False, logger=logger,
        num_workers=args.workers, worker_mode=args.worker_mode)
    det = build_detector(cfg, torch.device(args.device))
    loader.batch_transform = host_books.make_batch_transform(
        det.model, training=False)
    results = {}

    def evaluate(ckpt):
        epoch_id = epoch_from_path(ckpt)
        load_params_partial(ckpt, det.model.module, logger=logger)
        det.model.eval_mode()
        eval_dir = eval_root / ('epoch_%s' % epoch_id) / cfg.MODEL.TEST.SPLIT
        eval_dir.mkdir(parents=True, exist_ok=True)
        logger.info('*************** EPOCH %s EVALUATION ***************'
                    % epoch_id)
        results[epoch_id] = (eval_dir, eval_one_epoch(
            det, loader, dataset, cfg, result_dir=eval_dir, logger=logger,
            save_to_file=args.save_to_file))
        return epoch_id

    if not args.eval_all:
        if args.ckpt is None:
            raise ValueError('give --ckpt or --eval_all')
        evaluate(args.ckpt)
        return {'eval_root': eval_root, 'log_file': log_file,
                'detector': det, 'results': results}

    # the eval-all watcher (reference repeat_eval_ckpt:82-131)
    ckpt_dir = Path(args.ckpt_dir or (output_dir / 'ckpt'))
    record_file = eval_root / ('eval_list_%s.txt' % cfg.MODEL.TEST.SPLIT)
    evaluated = set()
    if record_file.exists():
        evaluated = set(record_file.read_text().split())
    waited = 0
    while True:
        todo = [c for c in list_checkpoints(str(ckpt_dir))
                if isinstance(epoch_from_path(c), int)
                and str(epoch_from_path(c)) not in evaluated
                and epoch_from_path(c) >= args.start_epoch]
        if not todo:
            if waited >= args.max_waiting_mins * 60:
                break
            time.sleep(WAIT_SECONDS)
            waited += WAIT_SECONDS
            continue
        waited = 0
        for ckpt in todo:
            epoch_id = evaluate(ckpt)
            evaluated.add(str(epoch_id))
            with open(record_file, 'a') as f:
                f.write('%s\n' % epoch_id)
    return {'eval_root': eval_root, 'log_file': log_file, 'detector': det,
            'results': results}


if __name__ == '__main__':
    main()
