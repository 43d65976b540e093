"""Entry `train`: `Trainer.step` over a pool of batches kept on the card.

Set-up makes the weights from the seed, builds the trainer
(`build_trainer`, the OneCycle schedule over the workload's epochs), loads
the weights, builds the pool with `Trainer.make_batch` (voxelization, the
program's default rulebooks and the host anchor targets, one upload per
batch) and drives the trainer through its first three steps on pool
batches 0, 1, 2: they warm every shape and are the steps the reference
follows.  The window steps the same trainer over the pool in a seeded
order and reads the losses only once it has closed, after a synchronise.

Correctness (`check`): the reference takes the same weights and the same
three batches' scans and steps three times in float32 (TF32 off); the
numbers compared are
  loss_gap   - the relative gap of the first step's losses (the later
      steps' are printed beside it);
  grad_gap   - the worst leaf's gap between the norms of the first
      gradient as the optimizer got it (the program's Adam first moment
      after one step over 1 - beta1) and the reference's clipped gradient;
  grad_err   - the norm of the difference of those two first gradients
      over the reference's, all leaves together (norms average rounding
      away; the difference keeps it, so this is the number that tells a
      lower precision);
  change_gap - the worst leaf's gap between the norms of the parameters'
      change over the three steps;
each leaf's gap over the larger of its reference norm and the median
leaf's.  Leaves whose reference gradient norm is under a thousandth of
the median leaf's are left out (`SMALL`).  A cell compares the numbers
that its workload file gives a limit.
"""
import time

import numpy as np
import torch

from ..harness import common, flops, scenes, trace
from ..reference import train as ref_train
from ..reference.anchors import Anchors
from ..reference.voxel import voxelize
from . import detect as detect_entry

SMALL = 1e-3
FIRST_STEPS = 3


class State:
    pass


def prepare(ctx):
    """The inputs both sides get: the pool's scans and boxes, and the
    weights from the seed (on the device, and a host copy)."""
    w, ref = ctx.work, ctx.ref
    st = State()
    dev = st.device = ctx.device
    data = ctx.cfg.DATA_CONFIG
    ids = scenes.scene_ids(ctx.seed, int(w['pool']), 0)
    st.points, st.mask, st.gt = scenes.make_pool(
        ids, ctx.cfg.CLASS_NAMES, w['scene'], int(data.MAX_POINTS),
        int(data.MAX_GT_BOXES))
    ctx.stage('scenes')
    st.weights = common.make_weights(ref.spec(), ctx.seed, dev)
    st.params = {k: v.cpu() for k, v in st.weights.items()}
    ctx.stage('weights')
    st.batch = int(w['batch'])
    st.batches = len(ids) // st.batch
    return st


def setup(ctx):
    from pcdet_tpu_torch.train.trainer import build_trainer
    w = ctx.work
    st = prepare(ctx)
    dev, b = st.device, st.batch
    st.trainer = build_trainer(ctx.cfg, dev, iters_each_epoch=int(
        w['iters_each_epoch']), epochs=int(w['epochs']))
    st.trainer.model.module.load_state_dict(st.weights)
    del st.weights
    ctx.stage('build')
    st.pool = []
    for i in range(0, st.batches * b, b):
        st.pool.append(st.trainer.make_batch(
            torch.as_tensor(st.points[i:i + b], device=dev),
            torch.as_tensor(st.mask[i:i + b], device=dev), st.gt[i:i + b]))
    ctx.stage('pool')
    common.reset_peak(dev)
    opt = st.trainer.state.optimizer
    names = opt.names
    p0 = {n: st.params[n] for n in names}
    st.first_losses = []
    for k in range(FIRST_STEPS):
        tb = st.trainer.step(st.pool[k])
        st.first_losses.append(float(tb['loss']))
        if k == 0:
            b1 = opt.mom(0)
            st.grads = {n: (m / (1 - b1)).detach().clone()
                        for n, m in zip(names, opt.state['mu'])}
            st.grad_norms = {n: float(torch.linalg.vector_norm(g))
                             for n, g in st.grads.items()}
    st.change_norms = {n: float(torch.linalg.vector_norm(
        p.detach().cpu() - p0[n])) for n, p in zip(names, opt.params)}
    st.steps_done = FIRST_STEPS
    common.sync()
    ctx.stage('first steps')
    return st


def order(ctx, n):
    rng = np.random.default_rng([int(ctx.seed), 2])
    while True:
        yield from rng.permutation(n)


def step(st, i):
    with trace.record_function('bench.step'):
        return st.trainer.step(st.pool[i])['loss']


def window(st, ctx):
    seq = order(ctx, len(st.pool))
    losses = []
    common.sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        losses.append(step(st, int(next(seq))))
    common.sync()
    wall = time.perf_counter() - t0
    vals = torch.stack(losses).cpu().numpy()
    samples = len(losses) * st.batch
    ctx.failed = int((~np.isfinite(vals)).sum())
    ctx.note('window: %d steps, %d samples in %.4f s; loss first %.6f '
             'last %.6f' % (len(losses), samples, wall, vals[0], vals[-1]))
    return {'samples_per_s': (samples / wall, 'samples/s')}, len(losses)


def traced(st, ctx):
    seq = order(ctx, len(st.pool))
    idx = [int(next(seq)) for _ in range(int(ctx.work['traced_batches']))]
    prof, wall, outs = trace.run_traced(lambda k: step(st, idx[k]), len(idx))
    ctx.failed = int(sum(not bool(torch.isfinite(x)) for x in outs))
    summary = trace.summarize(prof, wall)
    summary['batches'] = len(idx)
    ops, least = {}, 0.0
    for i in idx:
        o, s = batch_work(st, ctx, i)
        least += s
        for k, v in o.items():
            ops[k] = ops.get(k, 0) + v
    summary['ops'] = ops
    summary['sparse_least_s'] = least
    return summary, len(idx)


def batch_work(st, ctx, i):
    ref = ctx.ref
    b = st.batch
    pts = torch.as_tensor(st.points[i * b:(i + 1) * b], device=ctx.device)
    msk = torch.as_tensor(st.mask[i * b:(i + 1) * b], device=ctx.device)
    work, pillars = [], 0
    with torch.no_grad():
        vox = voxelize(pts, msk, ref.voxel_size, ref.pc_range,
                       ref.max_points, ref.caps['train'])
        if ref.kind == 'second':
            detect_entry.rule_work(ref, vox, b, True, work)
        else:
            pillars = len(vox['coords'])
    return flops.batch_ops(ref, ctx.conf['precision']['train'], work,
                           pillars, b, train=True)


def free(st):
    st.trainer = None
    st.pool = None
    common.reset_peak(st.device, reset=False)


def first_batches(st, ctx, steps=FIRST_STEPS):
    b = st.batch
    return [(st.points[k * b:(k + 1) * b], st.mask[k * b:(k + 1) * b],
             st.gt[k * b:(k + 1) * b]) for k in range(steps)]


def reference_steps(ctx, st, lower=False, keep=None):
    """The reference's three steps in float32 (`lower`: the control, one
    precision below the configuration's): (losses, {leaf: first gradient
    norm}, {leaf: change norm}, {leaf: first gradient})."""
    from ..reference.net import precision
    ref = ctx.ref
    anchors = Anchors(ref.cfg, ref.grid)
    params = {k: v.to(ctx.device) for k, v in st.params.items()}
    total = int(ctx.work['iters_each_epoch']) * int(ctx.work['epochs'])
    prec = precision(ctx.conf['precision']['train'], lower)
    with common.exact_f32():
        losses, first, last = ref_train.run_steps(
            ref, anchors, params, first_batches(st, ctx),
            ref.cfg['MODEL']['TRAIN']['OPTIMIZATION'], total, prec, keep)
    grads = {k: float(torch.linalg.vector_norm(v)) for k, v in first.items()}
    change = {k: float(torch.linalg.vector_norm(last[k] - params[k]))
              for k in last}
    return losses, grads, change, first


def program_side(st):
    """The program's (losses, gradient norms, change norms, gradients) of
    its first three steps, as set-up read them."""
    return st.first_losses, st.grad_norms, st.change_norms, st.grads


def kept(refr):
    """The leaves compared: a reference gradient norm of at least SMALL
    times the median leaf's (leaves whose gradient is nought to rounding
    move under Adam by round-off alone)."""
    med = float(np.median(list(refr[1].values())))
    return [k for k in refr[1] if refr[1][k] >= SMALL * med], med


def leaf_gaps(prog, refr):
    """{leaf: gap} of the first gradients' and of the changes' norms, over
    the leaves kept, each over the larger of its reference norm and the
    median leaf's."""
    keep, med_g = kept(refr)
    med_c = float(np.median([refr[2][k] for k in keep]))
    return ({k: abs(prog[1][k] - refr[1][k]) / max(refr[1][k], med_g)
             for k in keep},
            {k: abs(prog[2][k] - refr[2][k]) / max(refr[2][k], med_c)
             for k in keep})


def compare(prog, refr):
    """{loss_gap, grad_gap, grad_err, change_gap} of the program's (or a
    stand-in's) side against the reference's."""
    # the first step's: later steps' losses swing by Adam's near-sign
    # updates of the leaves' smallest gradients, seed to seed
    loss_gap = abs(prog[0][0] - refr[0][0]) / abs(refr[0][0])
    grad, change = leaf_gaps(prog, refr)
    keep, _ = kept(refr)
    diff = sum(float(torch.sum((prog[3][k].to(refr[3][k].device)
                                - refr[3][k]) ** 2)) for k in keep)
    norm = sum(float(torch.sum(refr[3][k] ** 2)) for k in keep)
    return {'loss_gap': loss_gap, 'grad_gap': max(grad.values()),
            'grad_err': (diff / norm) ** 0.5,
            'change_gap': max(change.values())}


def worst(gaps, n=3):
    """The n leaves of the largest gaps and the median gap, for notes."""
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return {'top': [[k, v] for k, v in top],
            'median': float(np.median(list(gaps.values())))}


def step_gaps(prog, refr):
    """Relative gaps of every step's loss (printed, not compared)."""
    return [abs(a - b) / abs(b) for a, b in zip(prog[0], refr[0])]


def diagnostics(prog, refr):
    grad, change = leaf_gaps(prog, refr)
    return {'step_loss_gaps': step_gaps(prog, refr), 'leaves': len(grad),
            'grad_leaves': worst(grad), 'change_leaves': worst(change)}


def check(st, ctx, record):
    refr = reference_steps(ctx, st)
    prog = program_side(st)
    ctx.diagnostics = diagnostics(prog, refr)
    ctx.note('reference losses %s, program %s; %s'
             % (['%.6f' % x for x in refr[0]],
                ['%.6f' % x for x in st.first_losses], ctx.diagnostics))
    return compare(prog, refr)
