"""Data-parallel training over `torch.distributed`: one process (rank) per
card, W ranks on one global batch.

Counterpart of `pcdet_tpu.parallel.mesh`.  There a 1-axis `data` mesh
shards the batch, the parameters are replicated, and XLA adds the
gradient psum; here each rank holds a replica and its share of the batch,
and the step sums what XLA summed:

- `all_reduce_grads`: the parameter gradients, flattened into buckets,
  one `all_reduce` a bucket (the port's step takes its gradients with
  `torch.autograd.grad`, so no `DistributedDataParallel` reducer would
  see them);
- `all_reduce_sum`: a differentiable sum over the ranks (its backward
  sums the incoming gradients over the ranks too), for the synced
  BatchNorm's statistics;
- `all_sum`: a sum of counts without a graph, for the losses' global
  normalizers;
- `broadcast_buffers`: rank 0's BatchNorm running statistics to every
  rank after a step, as JAX's replicated `batch_stats` take group 0's;
- `reduce_tb`: the logged tb scalars summed over the ranks.

Each of them is the identity without a group (`group=None`), so a
single-process run computes what it computed before, bit for bit.

`init_from_env` joins the group that torchrun's environment describes
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); `launch_local`
starts W ranks of a function on this host over a `file://` rendezvous
(the `spawn` start method, which CUDA needs: the function's module is
imported again in each child, so it must not import jax), on one device
or one card a rank.  NCCL serves CUDA and gloo the CPU by default; two
ranks on one card must take gloo, since NCCL refuses two ranks on a device
(gloo's `all_reduce` and `broadcast` take CUDA tensors).  Over NCCL the
gradient, BatchNorm and buffer collectives queue on the rank's stream and
do not wait on the card.
"""
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

ENV_KEYS = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')
BUCKET_BYTES = 25 << 20


def default_backend(device):
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def rank(group):
    """This process's rank in `group`; 0 without a group."""
    return 0 if group is None else dist.get_rank(group)


def world_size(group):
    """The ranks of `group`; 1 without a group."""
    return 1 if group is None else dist.get_world_size(group)


def rank_seed(seed, rank_):
    """The seed of rank `rank_`'s device generator: `seed` on rank 0, so a
    one-rank run draws what a run without a group draws."""
    return int(seed) + (int(rank_) << 32)


def init(backend, init_method, rank_, world, device=None):
    """Join a process group; return the default group.  `device` (a CUDA
    device) becomes the current device first, so NCCL binds to it."""
    if device is not None and torch.device(device).type == 'cuda':
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world)
    return dist.group.WORLD


def init_from_env(device_type='cuda', backend=None):
    """Join the process group of torchrun's environment.

    :param device_type: 'cuda' (the rank's device is cuda:LOCAL_RANK) or
        'cpu'; nothing falls back from one to the other
    :param backend: None: NCCL for 'cuda', gloo for 'cpu'
    :return: (group, device)
    """
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError(
            '--multi_host joins the process group torchrun describes, and '
            '%s are not set: launch with python -m torch.distributed.run '
            '--nproc_per_node N -m pcdet_tpu_torch.tools.train --multi_host '
            '...' % ', '.join(missing))
    local = int(os.environ['LOCAL_RANK'])
    device = (torch.device('cuda', local) if device_type == 'cuda'
              else torch.device(device_type))
    group = init(backend or default_backend(device), 'env://',
                 int(os.environ['RANK']), int(os.environ['WORLD_SIZE']),
                 device)
    return group, device


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the gradients over the ranks
    (each rank's loss reads the sum, so d(sum of losses) / dx_r is the sum
    of every rank's d loss / d sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """Differentiable sum of `x` over the ranks of `group`."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_sum(x, group):
    """Sum of `x` over the ranks, without a graph (counts)."""
    if group is None:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def _buckets(tensors, bucket_bytes):
    """Runs of consecutive indices of one dtype and device, each of at most
    `bucket_bytes` (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if cur and (t.dtype != tensors[cur[0]].dtype
                    or t.device != tensors[cur[0]].device
                    or size + nbytes > bucket_bytes):
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
    if cur:
        out.append(cur)
    return out


def _dense_perm(t):
    """The dims of `t` from the largest stride down, where that order makes
    it contiguous (a dense tensor in any memory format, such as a
    channels-last conv weight's gradient); else None."""
    perm = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    return perm if t.permute(perm).is_contiguous() else None


def all_reduce_grads(grads, group, bucket_bytes=BUCKET_BYTES):
    """The gradients summed over the ranks (XLA's psum over the mesh in
    `pcdet_tpu.train.train_state`): flattened into buckets, one
    `all_reduce` each.  Returns `grads` itself without a group, else a
    list of views into the reduced buckets with each gradient's strides
    (its elements go in memory order), so that a reduction over it (the
    optimizer's gradient norm) sums in the order it would have."""
    if group is None:
        return grads
    out = [None] * len(grads)
    for idx in _buckets(grads, bucket_bytes):
        perms = [_dense_perm(grads[i]) for i in idx]
        flat = torch.cat([
            (grads[i] if p is None else grads[i].permute(p)).reshape(-1)
            for i, p in zip(idx, perms)])
        dist.all_reduce(flat, group=group)
        offset = 0
        for i, p in zip(idx, perms):
            g, n = grads[i], grads[i].numel()
            part = flat[offset:offset + n]
            out[i] = (part.view(g.shape) if p is None
                      else part.as_strided(g.shape, g.stride()))
            offset += n
    return out


@torch.no_grad()
def broadcast_buffers(module, group, src=0):
    """Every buffer of `module` (the BatchNorms' running statistics and
    counts) takes rank `src`'s values, one broadcast a dtype."""
    if group is None:
        return
    buffers = [b for b in module.buffers() if b.numel()]
    for idx in _buckets(buffers, float('inf')):
        flat = torch.cat([buffers[i].reshape(-1) for i in idx])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for i in idx:
            n = buffers[i].numel()
            buffers[i].copy_(flat[offset:offset + n].view(buffers[i].shape))
            offset += n


def all_gather_object(obj, group):
    """[rank 0's obj, rank 1's, ...] (a collective); [obj] without a
    group."""
    if group is None:
        return [obj]
    out = [None] * world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(group):
    if group is not None:
        dist.barrier(group=group)


def tb_is_global(key):
    """tb values that every rank already holds for the global batch: the BEV
    head's IoU, made from summed intersections and unions in the step
    (`experiments.bev_seg_loss`)."""
    return key == 'miou' or key.startswith('iou_cls')


def reduce_tb(tb, group):
    """The tb dict of the global batch from each rank's: the loss terms
    (each rank's share) and the counts summed over the ranks, in one
    all-reduce (a collective: every rank calls it at the same steps)."""
    if group is None:
        return tb
    keys = [k for k in tb if not tb_is_global(k)]
    if not keys:
        return dict(tb)
    vals = torch.stack([torch.as_tensor(tb[k]).detach().to(torch.float64)
                        for k in keys])
    dist.all_reduce(vals, group=group)
    out = dict(tb)
    for k, v in zip(keys, vals):
        out[k] = v.to(torch.as_tensor(tb[k]).dtype)
    return out


def _rank_main(rank_, fn, world, init_method, backend, device, args):
    if isinstance(device, (list, tuple)):
        device = device[rank_]
    group = init(backend, init_method, rank_, world, device)
    try:
        fn(rank_, group, *args)
        # no rank leaves while another is still in a collective
        dist.barrier(group=group)
    finally:
        dist.destroy_process_group()


def launch_local(fn, world, args=(), backend='gloo', device=None,
                 timeout=600.0):
    """Run fn(rank, group, *args) in `world` spawned processes that join a
    group over a `file://` rendezvous in a temporary directory; wait at
    most `timeout` seconds, then stop every rank and raise.

    :param fn: a module-level function of a module that does not import jax
    :param device: the device every rank binds to (None: the CPU), or a
        sequence of one device a rank (NCCL takes one card a rank)
    """
    ctx = torch.multiprocessing.get_context('spawn')
    with tempfile.TemporaryDirectory() as tmp:
        init_method = 'file://' + os.path.join(tmp, 'rendezvous')
        procs = [ctx.Process(target=_rank_main, args=(
            r, fn, world, init_method, backend, device, args))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
                if p.exitcode is None:
                    raise TimeoutError('ranks still running after %.0f s'
                                       % timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                        p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError('ranks exited with codes %s' % codes)


def save_rank_result(path, rank_, obj):
    """Write a rank's result for the launching process (`load_rank_results`)."""
    with open('%s.rank%d' % (path, rank_), 'wb') as f:
        pickle.dump(obj, f)


def load_rank_results(path, world):
    out = []
    for r in range(world):
        with open('%s.rank%d' % (path, r), 'rb') as f:
            out.append(pickle.load(f))
    return out
