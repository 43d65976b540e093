"""Rank workers of the data-parallel tests (`test_torch_port_ddp*.py`,
`test_torch_port_gpu.py`), run by `parallel.ddp.launch_local`.  A spawned
rank imports this module again, so it imports neither jax nor pcdet_tpu
(only the port and `chip_smoke`, whose Part-A² helpers it shares).

`step_job` runs one job on one rank, or without a group on the whole
batch (the one-process reference): the trainer of `job['cfg']` with
`job['state']` loaded, optionally in f64, on this rank's share of the
global batch (`job['points']`, `mask`, `gt`; rank r takes samples r*b ..
r*b+b-1), then
- the step's loss, tb and gradients (summed over the ranks), and the BN
  running statistics once rank 0's were broadcast;
- `job['steps']` optimizer steps on a fresh trainer: the loss of each step
  and every tensor of the state afterwards (parameters, buffers, optimizer
  moments and count).
Part-A² takes `job['inject']` (the reference's proposals, sampler picks
and dropout masks for the global batch) so every run samples the same
RoIs, or records them (`job['record']`) with the last 4 RoI slots of each
sample moved onto its GT boxes, so that fg RoIs exist.
"""
import sys

import numpy as np
import torch

import chip_smoke
from pcdet_tpu_torch.config import EDict
from pcdet_tpu_torch.parallel import ddp
from pcdet_tpu_torch.train.trainer import build_trainer

def port_cfg(cfg):
    """A config as the port's own EDict, so that a rank unpickles no
    pcdet_tpu class."""
    return EDict(cfg)


def foreign_modules():
    """The jax and pcdet_tpu modules loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split('.')[0] in ('jax', 'pcdet_tpu', 'flax'))


def run_ranks(tmp_path, fn, payload, world=2, timeout=300, device=None,
              backend='gloo'):
    """fn(rank, group, path, payload) on `world` ranks spawned here (gloo;
    NCCL with one card a rank in `device`); their results in rank
    order."""
    path = str(tmp_path / 'result')
    ddp.launch_local(fn, world, (path, payload), timeout=timeout,
                     device=device, backend=backend)
    return ddp.load_rank_results(path, world)


def max_rel_err(got, want):
    """max |got - want| / max |want| (0 where want is all 0 and got too)."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    return err / scale if scale else err


def make_trainer(job, group, dev, bn_groups=1):
    tr = build_trainer(job['cfg'], dev, seed=0, total_steps=10,
                       bn_groups=bn_groups, process_group=group,
                       sync_bn=job.get('sync_bn', False))
    tr.model.module.load_state_dict(job['state'])
    if job.get('dtype') == 'float64':
        chip_smoke.parta2_to(tr, torch.float64)
    return tr


def make_rank_batch(job, tr, sl, dev):
    batch = tr.make_batch(torch.as_tensor(job['points'][sl], device=dev),
                          torch.as_tensor(job['mask'][sl], device=dev),
                          job['gt'][sl])
    dtype = next(tr.model.module.parameters()).dtype
    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in batch.items()}


def prepare(job, tr, rank, world, dev):
    """This rank's batch, with Part-A²'s RoIs injected (this rank's samples
    of the reference's proposals, picks and dropout masks) or recorded
    (`chip_smoke.parta2_gt_proposals`; the record's 'roi' after the
    forward); returns (batch, the record or None)."""
    b = len(job['points']) // world
    sl = slice(rank * b, rank * b + b)
    batch = make_rank_batch(job, tr, sl, dev)
    src = job.get('inject')
    if src is not None:
        r = int(src['picks'].shape[1])
        chip_smoke.parta2_inject(tr.model, {
            'roi': {k: v[sl] for k, v in src['roi'].items()},
            'picks': src['picks'][sl],
            'masks': [m[rank * b * r:(rank * b + b) * r]
                      for m in src['masks']]},
            dev, next(tr.model.module.parameters()).dtype)
    elif job.get('record'):
        chip_smoke.parta2_gt_proposals(tr.model, batch['gt_boxes'])
        return batch, chip_smoke.parta2_record(tr.model)
    return batch, None


def state_tensors(trainer):
    """Every tensor of the state by name (CPU copies), and the counts."""
    tensors, counts = chip_smoke.state_tensors(trainer)
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}, counts


def step_job(job, group=None, rank=0, dev=None, bn_groups=1):
    """See the module docstring; returns a dict of CPU results.  A job's
    'device' 'card' is the card `ddp.init` made current (a rank's own)."""
    if dev is None:
        dev = job.get('device', 'cpu')
        if dev == 'card':
            dev = torch.device('cuda', torch.cuda.current_device())
    dev = torch.device(dev)
    world = ddp.world_size(group)
    tr = make_trainer(job, group, dev, bn_groups)
    batch, rec = prepare(job, tr, rank, world, dev)
    before = chip_smoke.all_launches()
    loss, tb, grads = tr.state.loss_and_grads(batch)
    ddp.broadcast_buffers(tr.model.module, group)
    names = [n for n, _ in tr.model.module.named_parameters()]
    out = {'loss': float(ddp.all_sum(loss, group)), 'share': float(loss),
           'launches': {k: v - before.get(k, 0)
                        for k, v in chip_smoke.all_launches().items()
                        if v != before.get(k, 0)},
           'tb': {k: float(v) for k, v in ddp.reduce_tb(tb, group).items()},
           'grads': {n: g.detach().cpu().clone()
                     for n, g in zip(names, grads)},
           'stats': {k: v.detach().cpu().clone() for k, v in
                     tr.model.module.state_dict().items()
                     if k.endswith(('running_mean', 'running_var'))}}
    model = tr.model
    if getattr(model, 'last_sampler', None) is not None:
        out['sampler'] = {k: v.detach().cpu().clone() for k, v in
                          model.last_sampler.items()}
        if job.get('record'):
            out['inject'] = {'roi': {k: v.detach().cpu() for k, v in
                                     rec['roi'].items()},
                             'picks': model.last_sampler['picks'].cpu(),
                             'masks': [d.last_mask.cpu() for d in
                                       model.dropouts()
                                       if d.last_mask is not None]}
    losses = []
    if job.get('steps'):
        tr = make_trainer(job, group, dev, bn_groups)
        batch, _ = prepare(job, tr, rank, world, dev)
        for _ in range(job['steps']):
            tb = ddp.reduce_tb(tr.step(batch), group)
            losses.append(float(tb['loss']))
        out['state'] = state_tensors(tr)
    out['losses'] = losses
    return out


def step_rank(rank, group, path, jobs):
    """`launch_local`'s target: `step_job` of each job on this rank, the
    results saved under path.  f32 stays f32 on a card (no TF32)."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = [step_job(job, group, rank) for job in jobs]
    for r in out:
        r['foreign_modules'] = foreign_modules()
    ddp.save_rank_result(path, rank, out)


def loss_shares_rank(rank, group, path, cases):
    """Part-A²'s `unet_loss` / `rcnn_loss` on this rank's half of each
    case's batch, with the counts summed over the ranks: the loss share,
    the tb and the gradients by the predictions."""
    from pcdet_tpu_torch.models import parta2, roi_heads
    torch.set_num_threads(1)
    world = ddp.world_size(group)
    out = []
    for case in cases:
        if case['kind'] == 'unet':
            seg, reg, labels, parts = (np.asarray(case[k]) for k in (
                'seg', 'reg', 'labels', 'parts'))
            b = len(seg) // world
            sl = slice(rank * b, rank * b + b)
            ts = torch.as_tensor(seg[sl]).requires_grad_()
            treg = torch.as_tensor(reg[sl]).requires_grad_()
            loss, tb = parta2.unet_loss(ts, treg, torch.as_tensor(labels[sl]),
                                        torch.as_tensor(parts[sl]), group)
            grads = torch.autograd.grad(loss, (ts, treg))
        else:
            ret = case['ret']
            b = len(ret['rcnn_cls']) // world
            sl = slice(rank * b, rank * b + b)
            t = {k: torch.as_tensor(np.asarray(v)[sl]) for k, v in ret.items()}
            t['rcnn_cls'].requires_grad_()
            t['rcnn_reg'].requires_grad_()
            loss, tb = roi_heads.rcnn_loss(t, case['weights'], group=group)
            grads = torch.autograd.grad(loss, (t['rcnn_cls'], t['rcnn_reg']))
        out.append({'share': float(loss),
                    'loss': float(ddp.all_sum(loss.detach(), group)),
                    'tb': {k: float(v) for k, v in
                           ddp.reduce_tb(tb, group).items()},
                    'grads': [g.numpy() for g in grads]})
    ddp.save_rank_result(path, rank, out)


def bn_rank(rank, group, path, cases):
    """`BatchNorm` synced over the ranks on this rank's share of each case's
    (f64) input: the output, the input's gradient under the case's
    cotangent, this rank's parameter gradients and the running statistics
    (on the CPU).  With `case['card']` on this rank's card, the forward and
    backward under torch.cuda's sync debug mode 'error' (a host sync
    raises), after one collective has brought the communicator up."""
    from pcdet_tpu_torch.models.layers import BatchNorm, set_batch_norm
    torch.set_num_threads(1)
    world = ddp.world_size(group)
    out = []
    for case in cases:
        card = case.get('card', False)
        dev = (torch.device('cuda', torch.cuda.current_device()) if card
               else torch.device('cpu'))
        x, cot, mask = case['x'], case['cot'], case.get('mask')
        b = len(x) // world
        sl = slice(rank * b, rank * b + b)
        bn = BatchNorm(x.shape[case.get('channel_dim', -1)],
                       channel_dim=case.get('channel_dim', -1)).double()
        bn.weight.data.copy_(torch.as_tensor(case['scale']))
        bn.bias.data.copy_(torch.as_tensor(case['bias']))
        bn.to(dev)
        set_batch_norm(bn, process_group=group)
        bn.train()
        tx = torch.as_tensor(x[sl], device=dev).requires_grad_()
        tmask = None if mask is None else torch.as_tensor(mask[sl],
                                                          device=dev)
        tcot = torch.as_tensor(cot[sl], device=dev)
        if card:
            ddp.all_sum(torch.zeros(1, device=dev), group)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode('error')
        try:
            y = bn(tx, tmask)
            dx, dw, db = torch.autograd.grad((y * tcot).sum(),
                                             (tx, bn.weight, bn.bias))
        finally:
            if card:
                torch.cuda.set_sync_debug_mode(0)
        out.append({k: v.detach().cpu() for k, v in (
            ('y', y), ('dx', dx), ('dw', dw), ('db', db),
            ('mean', bn.running_mean), ('var', bn.running_var))})
    ddp.save_rank_result(path, rank, out)


def collectives_rank(rank, group, path, _):
    """The helpers on rank-dependent tensors: the bucketed gradient
    all-reduce (buckets of 64 bytes, mixed dtypes), the differentiable sum
    and its backward, `reduce_tb`, the buffer broadcast."""
    torch.set_num_threads(1)
    gen = torch.Generator().manual_seed(rank)
    grads = [torch.randn(3, generator=gen, dtype=torch.float64),
             torch.randn(5, 4, generator=gen, dtype=torch.float64),
             torch.randint(0, 9, (7,), generator=gen),
             torch.randn(2, 2, generator=gen, dtype=torch.float64)]
    summed = ddp.all_reduce_grads([g.clone() for g in grads], group,
                                  bucket_bytes=64)
    x = torch.randn(4, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    y = ddp.all_reduce_sum(x, group)
    (dx,) = torch.autograd.grad((y * (rank + 1.0)).sum(), (x,))
    tb = {'loss': torch.tensor(rank + 0.5), 'miou': torch.tensor(0.25)}
    module = torch.nn.BatchNorm1d(3)
    module.running_mean.fill_(float(rank))
    ddp.broadcast_buffers(module, group)
    ddp.save_rank_result(path, rank, {
        'grads': grads, 'summed': summed, 'x': x.detach(), 'y': y.detach(),
        'dx': dx, 'tb': {k: float(v) for k, v in
                         ddp.reduce_tb(tb, group).items()},
        'mean': module.running_mean.clone()})
