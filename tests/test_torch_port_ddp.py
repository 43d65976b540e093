"""The port's data-parallel pieces on the CPU (`pcdet_tpu_torch.parallel.
ddp`, BatchNorm's two modes, the losses' global normalizers, the loader's
shards), two gloo ranks spawned from the test where ranks are needed
(`ddp_ranks.py` holds their code):

- `BatchNorm(groups=g)` against `pcdet_tpu`'s `TorchBatchNorm` under
  `set_bn_groups(g)`, masked and unmasked, and a leading axis that `g`
  does not divide (one group): the output to 1e-5 of its largest value,
  its gradient too, and the running statistics (group 0's) to 1e-6; NCHW
  groups equal to the channels-last ones;
- BatchNorm synced over two ranks (`--sync_bn`) against one process on
  the whole batch, in f64: output, input and parameter gradients and the
  running statistics to 1e-12 of their largest value;
- the collectives: the bucketed gradient all-reduce (mixed dtypes, several
  buckets) equal to the sum bit for bit and on both ranks, the
  differentiable sum's backward, `reduce_tb` (the BEV IoU left as it is),
  the buffer broadcast, and each of them the identity without a group;
- the loader: 5 samples over 2 ranks at batch 1, `len()` equal to what
  each rank iterates and equal on both ranks, with and without drop_last
  (the parent's loader gave rank 0 three batches, rank 1 two);
- Part-A²'s `unet_loss` and `rcnn_loss` as the sum of two ranks' shares
  with the all-reduced counts, against `pcdet_tpu`'s functions on the whole
  batch: loss and tb to 1e-6 relative, the gradients to 1e-6 of max; with
  one rank holding no positive voxel and no fg RoI too.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdet_tpu.models import layers as jax_layers
from pcdet_tpu.models import parta2 as jax_parta2
from pcdet_tpu.models import roi_heads as jax_roi
from pcdet_tpu_torch.datasets.loader import DataLoader
from pcdet_tpu_torch.models.layers import BatchNorm, set_batch_norm
from pcdet_tpu_torch.parallel import ddp

import ddp_ranks
from test_torch_port_parta2_train import LOSS_WEIGHTS, _rcnn_inputs

torch.set_num_threads(1)


def _close(got, want, tol, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _launch(tmp_path, fn, payload):
    return ddp_ranks.run_ranks(tmp_path, fn, payload, timeout=180)


# ---------------------------------------------------------- BN groups ---

def _jax_bn(x, mask, groups, scale, bias, mean, var, cot):
    """pcdet_tpu's TorchBatchNorm under set_bn_groups(groups): output, the
    input's gradient under `cot`, the new running statistics."""
    jax_layers.set_bn_groups(groups)
    try:
        bn = jax_layers.TorchBatchNorm(features=x.shape[-1])
        variables = {'params': {'scale': jnp.asarray(scale),
                                'bias': jnp.asarray(bias)},
                     'batch_stats': {'mean': jnp.asarray(mean),
                                     'var': jnp.asarray(var)}}
        m = None if mask is None else jnp.asarray(mask)

        def f(xx):
            return bn.apply(variables, xx, True, m, mutable=['batch_stats'])

        (y, stats), vjp = jax.vjp(f, jnp.asarray(x))
        (dx,) = vjp((jnp.asarray(cot), jax.tree_util.tree_map(
            jnp.zeros_like, stats)))
        return (np.asarray(y), np.asarray(dx),
                np.asarray(stats['batch_stats']['mean']),
                np.asarray(stats['batch_stats']['var']))
    finally:
        jax_layers.set_bn_groups(1)


def _bn_case(shape, masked, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    mask = (rng.rand(*shape[:-1]) > 0.3) if masked else None
    c = shape[-1]
    return (x, mask, rng.uniform(0.5, 1.5, c).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize('shape,masked,groups', [
    ((4, 7, 5, 6), True, 2),           # the PFN's (B, V, P, C), per-row mask
    ((4, 9, 6), True, 4),              # a sparse level's (B, V, C)
    ((6, 3, 3, 3, 5), True, 3),        # the RCNN's (B R, o, o, o, C)
    ((4, 5, 5, 6), False, 2),          # an RPN map (NHWC here)
    ((6, 8), False, 2),                # the RCNN's FCs (B R, C)
    ((4, 9, 6), True, 3),              # 3 does not divide 4: one group
])
def test_bn_groups_match_jax(shape, masked, groups):
    x, mask, scale, bias, mean, var, cot = _bn_case(shape, masked, 7)
    want_y, want_dx, want_mean, want_var = _jax_bn(x, mask, groups, scale,
                                                   bias, mean, var, cot)
    bn = BatchNorm(shape[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(scale))
        bn.bias.copy_(torch.as_tensor(bias))
        bn.running_mean.copy_(torch.as_tensor(mean))
        bn.running_var.copy_(torch.as_tensor(var))
    set_batch_norm(bn, groups=groups)
    bn.train()
    tx = torch.as_tensor(x).requires_grad_()
    y = bn(tx, None if mask is None else torch.as_tensor(mask))
    (dx,) = torch.autograd.grad((y * torch.as_tensor(cot)).sum(), (tx,))
    _close(y.detach().numpy(), want_y, 1e-5, 'y')
    _close(dx.numpy(), want_dx, 1e-5, 'dx')
    np.testing.assert_allclose(bn.running_mean.numpy(), want_mean, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, rtol=0,
                               atol=1e-6)
    if shape[0] % groups:
        # one group: the whole batch, as groups=1 computes it, bit for bit
        one = BatchNorm(shape[-1])
        one.load_state_dict({k: v for k, v in bn.state_dict().items()})
        with torch.no_grad():
            one.running_mean.copy_(torch.as_tensor(mean))
            one.running_var.copy_(torch.as_tensor(var))
        one.train()
        assert torch.equal(one(torch.as_tensor(x), None if mask is None
                               else torch.as_tensor(mask)), y.detach())


def test_bn_groups_nchw_equal_channels_last():
    x, _, scale, bias, _, _, _ = _bn_case((4, 5, 6, 3), False, 3)
    out = []
    for channel_dim, t in ((-1, torch.as_tensor(x)),
                           (1, torch.as_tensor(x).permute(0, 3, 1, 2))):
        bn = BatchNorm(3, channel_dim=channel_dim)
        with torch.no_grad():
            bn.weight.copy_(torch.as_tensor(scale))
            bn.bias.copy_(torch.as_tensor(bias))
        set_batch_norm(bn, groups=2)
        bn.train()
        y = bn(t)
        out.append((y if channel_dim == -1 else y.permute(0, 2, 3, 1),
                    bn.running_mean.clone(), bn.running_var.clone()))
    for a, b in zip(*out):
        _close(a.detach().numpy(), b.detach().numpy(), 1e-6)


def test_set_batch_norm_sets_each_module():
    assert ddp.world_size(None) == 1 and ddp.rank(None) == 0
    bn = BatchNorm(4)
    set_batch_norm(bn, groups=2)
    assert bn.groups == 2 and bn.process_group is None
    set_batch_norm(bn)
    assert bn.groups == 1


# ----------------------------------------------------------- sync BN ----

def _sync_cases():
    rng = np.random.RandomState(11)
    cases = []
    for shape, masked, channel_dim in (((4, 7, 5, 6), True, -1),
                                       ((4, 9, 6), True, -1),
                                       ((4, 6, 5, 5), False, 1),
                                       ((6, 8), False, -1)):
        c = shape[channel_dim]
        case = {'x': rng.randn(*shape) * 2 + 1, 'cot': rng.randn(*shape),
                'scale': rng.uniform(0.5, 1.5, c), 'bias': rng.randn(c) * 0.1,
                'channel_dim': channel_dim}
        if masked:
            case['mask'] = rng.rand(*shape[:-1]) > 0.3
        cases.append(case)
    return cases


def test_sync_bn_over_two_ranks_equals_one_process(tmp_path):
    cases = _sync_cases()
    ranks = _launch(tmp_path, ddp_ranks.bn_rank, cases)
    for i, case in enumerate(cases):
        x = torch.as_tensor(case['x'])
        bn = BatchNorm(x.shape[case['channel_dim']],
                       channel_dim=case['channel_dim']).double()
        with torch.no_grad():
            bn.weight.copy_(torch.as_tensor(case['scale']))
            bn.bias.copy_(torch.as_tensor(case['bias']))
        bn.train()
        tx = x.clone().requires_grad_()
        mask = case.get('mask')
        y = bn(tx, None if mask is None else torch.as_tensor(mask))
        dx, dw, db = torch.autograd.grad(
            (y * torch.as_tensor(case['cot'])).sum(), (tx, bn.weight, bn.bias))
        got = [r[i] for r in ranks]
        _close(torch.cat([g['y'] for g in got]), y.detach(), 1e-12, 'y')
        _close(torch.cat([g['dx'] for g in got]), dx, 1e-12, 'dx')
        _close(sum(g['dw'] for g in got), dw, 1e-12, 'dw')
        _close(sum(g['db'] for g in got), db, 1e-12, 'db')
        for g in got:
            _close(g['mean'], bn.running_mean, 1e-12, 'running mean')
            _close(g['var'], bn.running_var, 1e-12, 'running var')


# -------------------------------------------------------- collectives ---

def test_collectives_over_two_ranks(tmp_path):
    r0, r1 = _launch(tmp_path, ddp_ranks.collectives_rank, None)
    for i, (a, b) in enumerate(zip(r0['grads'], r1['grads'])):
        want = a + b
        assert r0['summed'][i].dtype == want.dtype
        assert torch.equal(r0['summed'][i], want), i
        assert torch.equal(r1['summed'][i], want), i
    assert torch.equal(r0['y'], r0['x'] + r1['x'])
    # d/dx_r of sum_r' (r' + 1) * sum(y): every rank's weight, summed
    assert torch.equal(r0['dx'], torch.full((4,), 3.0, dtype=torch.float64))
    assert torch.equal(r1['dx'], r0['dx'])
    for r in (r0, r1):
        assert r['tb'] == {'loss': 2.0, 'miou': 0.25}
        assert torch.equal(r['mean'], torch.zeros(3))


def test_collectives_without_a_group_are_the_identity():
    grads = (torch.randn(3), torch.randn(2, 2))
    assert ddp.all_reduce_grads(grads, None) is grads
    x = torch.randn(3)
    assert ddp.all_reduce_sum(x, None) is x and ddp.all_sum(x, None) is x
    tb = {'loss': torch.tensor(1.0)}
    assert ddp.reduce_tb(tb, None) is tb
    assert ddp.all_gather_object(5, None) == [5]
    module = torch.nn.BatchNorm1d(2)
    ddp.broadcast_buffers(module, None)
    ddp.barrier(None)
    assert ddp.rank_seed(7, 0) == 7 and ddp.rank_seed(7, 1) != 7


def test_init_from_env_names_the_launch(monkeypatch):
    for key in ddp.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match='torch.distributed.run'):
        ddp.init_from_env('cpu')


# ------------------------------------------------------------- loader ---

def _samples(n):
    return [{'frame': np.full((1,), i)} for i in range(n)]


@pytest.mark.parametrize('drop_last', [True, False])
def test_loader_gives_every_rank_the_batches_it_counts(drop_last):
    """5 samples over 2 ranks at batch 1: the parent's loader iterated 3
    batches on rank 0 and 2 on rank 1 while len() said 3 for both, so
    rank 0's third step would wait in a collective forever."""
    counts, seen = [], []
    for host in range(2):
        loader = DataLoader(_samples(5), batch_size=1, num_workers=0,
                            host_id=host, num_hosts=2, drop_last=drop_last,
                            seed=3)
        loader.set_epoch(1)
        batches = list(loader)
        counts.append((len(loader), len(batches)))
        seen += loader._epoch_indices().tolist()
    assert counts[0] == counts[1], counts
    assert counts[0][0] == counts[0][1], counts
    assert counts[0][0] == (2 if drop_last else 3)
    if drop_last:
        assert len(set(seen)) == 4            # the tail sample is dropped
    else:
        assert set(seen) == set(range(5))     # padded by wrapping


@pytest.mark.parametrize('n,hosts,bs', [(7, 1, 2), (9, 3, 2), (8, 2, 3)])
def test_loader_shards_are_equal(n, hosts, bs):
    for drop_last in (True, False):
        lens = set()
        for host in range(hosts):
            loader = DataLoader(_samples(n), batch_size=bs, num_workers=0,
                                host_id=host, num_hosts=hosts,
                                drop_last=drop_last)
            assert len(loader) == len(list(loader))
            lens.add(len(loader))
        assert len(lens) == 1
    # one host: every sample once, shuffled as before
    if hosts == 1:
        loader = DataLoader(_samples(n), batch_size=bs, num_workers=0,
                            drop_last=False, seed=0)
        idx = np.arange(n)
        np.random.RandomState(0).shuffle(idx)
        np.testing.assert_array_equal(loader._epoch_indices(), idx)


# ------------------------------------------------- Part-A²'s loss shares -

def _unet_case(seed, empty_rank1=False):
    rng = np.random.RandomState(seed)
    labels = rng.choice([-1, 0, 0, 0, 1, 2], (2, 300)).astype(np.int32)
    if empty_rank1:
        labels[1] = np.minimum(labels[1], 0)     # no positive voxel
    return {'kind': 'unet', 'seg': rng.randn(2, 300, 1).astype(np.float32),
            'reg': rng.randn(2, 300, 3).astype(np.float32),
            'labels': labels,
            'parts': rng.rand(2, 300, 3).astype(np.float32)}


def _rcnn_case(seed, empty_rank1=False):
    ret = {k: v.copy() for k, v in _rcnn_inputs(seed).items()}
    if empty_rank1:
        ret['reg_valid_mask'][1] = 0             # no fg RoI
    return {'kind': 'rcnn', 'ret': ret, 'weights': LOSS_WEIGHTS}


def _jax_loss(case):
    if case['kind'] == 'unet':
        fn = (lambda s, r: jax_parta2.unet_loss(
            s, r, jnp.asarray(case['labels']), jnp.asarray(case['parts'])))
        args = (case['seg'], case['reg'])
    else:
        ret = case['ret']
        fn = (lambda c, r: jax_roi.rcnn_loss(dict(
            {k: jnp.asarray(v) for k, v in ret.items()}, rcnn_cls=c,
            rcnn_reg=r), case['weights']))
        args = (ret['rcnn_cls'], ret['rcnn_reg'])
    (loss, tb), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    grads = vjp((jnp.float32(1.0), {k: jnp.zeros(()) for k in tb}))
    return float(loss), {k: float(v) for k, v in tb.items()}, grads


def test_parta2_loss_shares_match_jax(tmp_path):
    cases = [_unet_case(2), _unet_case(5, empty_rank1=True),
             _rcnn_case(0), _rcnn_case(1, empty_rank1=True)]
    assert cases[3]['ret']['reg_valid_mask'][0].any()
    ranks = _launch(tmp_path, ddp_ranks.loss_shares_rank, cases)
    for i, case in enumerate(cases):
        loss, tb, grads = _jax_loss(case)
        got = [r[i] for r in ranks]
        for g in got:
            np.testing.assert_allclose(g['loss'], loss, rtol=1e-6,
                                       err_msg=str(i))
            assert sorted(g['tb']) == sorted(tb)
            for k in tb:
                np.testing.assert_allclose(g['tb'][k], tb[k], rtol=1e-6,
                                           atol=1e-7, err_msg='%d %s' % (i, k))
        np.testing.assert_allclose(got[0]['share'] + got[1]['share'], loss,
                                   rtol=1e-6)
        for j, want in enumerate(grads):
            _close(np.concatenate([g['grads'][j] for g in got]), want, 1e-6,
                   '%d grad %d' % (i, j))
        if i in (1, 3):
            # the empty rank still has a share: its bg terms over the
            # global normalizer
            assert got[1]['share'] != 0.0


def test_rank_workers_import_no_jax():
    code = ('import sys; sys.path.insert(0, %r); import ddp_ranks; '
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'pcdet_tpu', 'flax')); print(bad); "
            'sys.exit(1 if bad else 0)' % os.path.dirname(__file__))
    import subprocess
    import sys
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
