"""pcdet_tpu_torch training pieces vs pcdet_tpu (CPU, small shapes).

- kernel D's plain version (`ops/gather_dw.gather_dw`, summed over the
  batch) against the three Pallas dW kernels it replaces, run in interpret
  mode per sample and summed: `gather_dw` (K = 27 and 3), `gather_dw_seg`
  and `gather_dw_xwin` (kw = 3 books, inputs prepared as `_dw_any` does);
  1e-5 of max |want|;
- the sparse convs' backward through `RulebookConv` (the mirrored book for
  subm, the transposed book for strided) against `jax.vjp` of
  `pcdet_tpu.ops.sparse.subm_conv3d_batched` / `sparse_conv3d_batched` over
  the same host books, and against torch autograd through
  `gather_gemm_plain` (an independent check of the two formulas); 1e-5 of
  max |grad|;
- `transpose_rules` equal to `_transpose_rules_from_fwd` as integers;
- train BatchNorm, masked and unmasked, against `TorchBatchNorm` train:
  outputs and new running statistics to 1e-6;
- `anchor_head_loss` against JAX on random heads and `assign` targets:
  each tb term to 1e-5 relative;
- adam_onecycle against the optax chain of `build_optimizer_and_schedule`
  on identical gradients for 5 steps: parameters to 1e-6, lr / momentum to
  1e-7 at steps 0, split and total;
- the voxelizer's overflow count against a numpy count of occupied cells.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tiny_config import tiny_second_cfg

from pcdet_tpu.models import rpn_head as jax_rpn
from pcdet_tpu.models.anchors import AnchorHeadTargets
from pcdet_tpu.models.layers import TorchBatchNorm
from pcdet_tpu.ops import host_books as jax_books
from pcdet_tpu.ops import sparse as jax_sparse
from pcdet_tpu.ops.pallas import gather_gemm as gg
from pcdet_tpu.train import optimization as jax_opt
from pcdet_tpu_torch.models.layers import BatchNorm
from pcdet_tpu_torch.models.rpn_head import anchor_head_loss
from pcdet_tpu_torch.ops import gather_dw, gather_gemm, host_books, sparse
from pcdet_tpu_torch.ops.voxelizer import voxelize_torch
from pcdet_tpu_torch.train import optimization

torch.set_num_threads(1)

TOL = 1e-5
SHAPE = (7, 24, 40)
CAP = 300
N_LIVE = (260, 170)
CAPS = (320, 256, 192, 160)
LAST_PAD = (1, 0, 0)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _run_coords(rng, n_live, cap, shape):
    """Sorted coords of x-runs (LiDAR-like neighbourhoods), -1 padded."""
    coords = np.full((len(n_live), cap, 3), -1, np.int32)
    for b, n in enumerate(n_live):
        ids = set()
        while len(ids) < n:
            z, y = rng.randint(shape[0]), rng.randint(shape[1])
            x = rng.randint(shape[2] - 6)
            for i in range(rng.randint(1, 6)):
                ids.add((z * shape[1] + y) * shape[2] + x + i)
        ids = np.sort(np.fromiter(ids, np.int64))[:n]
        coords[b, :n] = np.stack([ids // (shape[1] * shape[2]),
                                  (ids // shape[2]) % shape[1],
                                  ids % shape[2]], -1)
    return coords


@pytest.fixture(scope='module')
def books():
    rng = np.random.RandomState(0)
    coords = _run_coords(rng, N_LIVE, CAP, SHAPE)
    mask = coords[..., 0] >= 0
    spec = jax_books.encoder_spec(SHAPE, CAPS, LAST_PAD)
    flat = jax_books.build_books_batch(coords, mask, SHAPE, spec)
    port = host_books.upload_books(flat, spec, CAP, 'cpu')
    shapes, shape = {}, SHAPE
    for op in spec:
        if op[0] == 'spconv':
            shapes[op[1]] = shape                  # the conv's input shape
            shape = sparse.conv_out_shape(shape, *op[2:5])
    return {'coords': coords, 'mask': mask, 'spec': spec, 'flat': flat,
            'jax': jax_books.unpack_books(flat), 'port': port,
            'in_shapes': shapes}


def _level_of(books, key):
    """(coords, mask, shape, n_in) of the input level of strided conv `key`
    ('spconv2' reads the full-resolution level)."""
    prev = {'spconv2': None, 'spconv3': 'spconv2', 'spconv4': 'spconv3',
            'convout': 'spconv4'}[key]
    if prev is None:
        return books['coords'], books['mask'], SHAPE, CAP
    _, crd, msk, _, _ = books['port'][prev]
    cap = {op[1]: op[5] for op in books['spec'] if op[0] == 'spconv'}[prev]
    return crd.numpy(), msk.numpy(), books['in_shapes'][key], cap


def _dw_inputs(books, key, cin, cout, seed):
    """Table (B, V_in + 1, Cin), rules, g (B, V_out, Cout) nonzero on dead
    rows too, n_live of a book."""
    rng = np.random.RandomState(seed)
    if key.startswith('subm'):
        rules = books['port'][key].numpy()
        mask = (books['mask'] if key == 'subm1' else
                books['port']['spconv' + key[-1]][2].numpy())
        out_mask = mask
    else:
        _, _, out_mask, _, rules = books['port'][key]
        rules, out_mask = rules.numpy(), out_mask.numpy()
        _, mask, _, _ = _level_of(books, key)
    v_in = mask.shape[1]
    table = np.zeros((2, v_in + 1, cin), np.float32)
    table[:, :v_in] = rng.randn(2, v_in, cin) * mask[..., None]
    g = rng.randn(2, rules.shape[1], cout).astype(np.float32)
    return table, rules, g, out_mask.sum(1).astype(np.int32)


@pytest.mark.parametrize('key,cin,cout', [('subm2', 16, 32),
                                          ('convout', 64, 128)])
def test_plain_d_matches_gather_dw(books, key, cin, cout, monkeypatch):
    monkeypatch.setattr(gg, 'INTERPRET', True)
    table, rules, g, n_live = _dw_inputs(books, key, cin, cout, 1)
    got = gather_dw.gather_dw(*map(torch.as_tensor, (table, rules, g, n_live)))
    assert got.shape == (rules.shape[2], cin, cout)
    want = sum(np.asarray(gg.gather_dw(jnp.asarray(table[b]),
                                       jnp.asarray(rules[b]),
                                       jnp.asarray(g[b]),
                                       jnp.int32(n_live[b])))
               for b in range(2))
    _close(got.numpy(), want)


@pytest.mark.parametrize('variant', ['seg', 'xwin'])
def test_plain_d_matches_window_dw_kernels(books, variant, monkeypatch):
    """D′ and D″ on a kw = 3 book, inputs as `_dw_any` prepares them, at
    64-row tiles (the PCDET_GATHER_TV knob) to keep interpret mode short."""
    monkeypatch.setattr(gg, 'INTERPRET', True)
    monkeypatch.setattr(gg, 'TV', 64)
    table, rules, g, n_live = _dw_inputs(books, 'subm1', 16, 16, 2)
    got = gather_dw.gather_dw(*map(torch.as_tensor, (table, rules, g, n_live)))
    want = 0
    for b in range(2):
        fp, r = jnp.asarray(table[b]), jnp.asarray(rules[b])
        base, sel = jax_sparse._xwin_selectors(r, fp.shape[0] - 1)
        pad = gg.SEG_S - 1 if variant == 'seg' else 1
        fp2 = jnp.concatenate([fp, jnp.zeros((pad, fp.shape[1]))], axis=0)
        fn = gg.gather_dw_seg if variant == 'seg' else gg.gather_dw_xwin
        want = want + np.asarray(fn(fp2, base, sel, jnp.asarray(g[b]),
                                    jnp.int32(n_live[b])))
    _close(got.numpy(), want)


def test_plain_d_gates_rows_past_n_live():
    rng = np.random.RandomState(3)
    b, v, k, cin, cout = 2, 90, 27, 4, 16
    table = torch.as_tensor(rng.randn(b, v + 1, cin).astype(np.float32))
    table[:, v] = 0
    rules = torch.as_tensor(rng.randint(0, v + 1, (b, v, k)).astype(np.int32))
    g = torch.as_tensor(rng.randn(b, v, cout).astype(np.float32))
    live = torch.tensor([37, v], dtype=torch.int32)
    before = dict(gather_dw.LAUNCHES)
    got = gather_dw.gather_dw(table, rules, g, live)
    assert gather_dw.LAUNCHES == before        # the CPU path counts nothing
    g_cut = g.clone()
    g_cut[0, 37:] = 0
    want = gather_dw.gather_dw(table, rules, g_cut,
                               torch.full((b,), v, dtype=torch.int32))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_plain_d_refuses_bad_inputs():
    rng = np.random.RandomState(0)
    table = torch.as_tensor(rng.randn(1, 11, 16).astype(np.float32))
    rules = torch.zeros((1, 8, 27), dtype=torch.int32)
    g = torch.zeros((1, 8, 32))
    n = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(TypeError):
        gather_dw.gather_dw(table.bfloat16(), rules, g, n)
    with pytest.raises(TypeError):
        gather_dw.gather_dw(table, rules.long(), g, n)
    with pytest.raises(ValueError):
        gather_dw.gather_dw(table, rules, g[:, :5].contiguous(), n)
    with pytest.raises(ValueError):
        gather_dw.gather_dw(table, rules[:, ::2], g[:, ::2], n)


@pytest.mark.parametrize('b,v_out,blocks,resident,want', [
    (2, 32000, 9, 264, 576),      # D′ at conv2_1, B2, two blocks per SM
    (8, 32000, 9, 264, 2304),     # the same at B8
    (2, 11264, 1, 132, 256),      # D at conv_out: four sub-tiles a chunk
    (2, 200, 9, 8, 256),          # more tap blocks than the waves hold
    (3, 40, 21, 1056, 64)])       # fewer rows than one sub-tile
def test_d_chunk_rows_fill_the_waves(b, v_out, blocks, resident, want):
    """A dW kernel's chunks: whole 64-row sub-tiles, as few per chunk as
    keep the (chunk, tap block, sample) grid within `_WAVES` waves of
    resident blocks, but `_MIN_TILES` at least."""
    rows = gather_dw.chunk_rows(b, v_out, blocks, resident)
    assert rows == want
    tiles = -(-v_out // 64)
    assert rows // 64 >= min(gather_dw._MIN_TILES, tiles)
    grid = -(-v_out // rows) * blocks * b
    assert grid <= max(gather_dw._WAVES * resident, blocks * b)


@pytest.mark.parametrize('key', ['spconv2', 'spconv4', 'convout'])
def test_transpose_rules_matches_jax(books, key):
    _, _, _, _, rules = books['port'][key]
    _, mask, _, n_in = _level_of(books, key)
    n_out = rules.shape[1]
    got = sparse.transpose_rules(rules, n_in, n_out).numpy()
    assert got.shape == (2, n_in, rules.shape[2])
    for b in range(2):
        want = np.asarray(jax_sparse._transpose_rules_from_fwd(
            jnp.asarray(rules[b].numpy()), n_in, n_out))
        np.testing.assert_array_equal(got[b], want)
    assert (got != n_out).any() and (got == n_out).any()


def _jax_conv_vjp(books, conv, feats, coords, mask, shape, w, g):
    level = jax_sparse.from_voxelizer(jnp.asarray(feats), jnp.asarray(coords),
                                      jnp.asarray(mask), shape)

    def f(x, wt):
        lv = level._replace(features=x)
        if conv == 'subm':
            out = jax_sparse.subm_conv3d_batched(lv, wt, kernel=3,
                                                 book=books['jax']['subm1'])
        else:
            geom = _GEOM[conv]
            out = jax_sparse.sparse_conv3d_batched(
                lv, wt, kernel=geom[0], stride=geom[1], padding=geom[2],
                out_cap=geom[3], book=books['jax'][conv])
        return out.features

    out, vjp = jax.vjp(f, level.features, jnp.asarray(w))
    df, dw = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(df), np.asarray(dw)


_GEOM = {'spconv2': ((3, 3, 3), (2, 2, 2), (1, 1, 1), CAPS[0]),
         'convout': ((3, 1, 1), (2, 1, 1), LAST_PAD, CAPS[3])}


def _plain_autograd(table_rows, w, rules, out_mask):
    """Autograd through gather_gemm_plain: the formulas' independent check."""
    b, _, cin = table_rows.shape
    table = torch.cat([table_rows, table_rows.new_zeros((b, 1, cin))], 1)
    n_live = out_mask.sum(1, dtype=torch.int32)
    out = gather_gemm.gather_gemm_plain(table, rules, w, n_live)
    return out * out_mask[..., None].float()


@pytest.mark.parametrize('conv,cin,cout', [('subm', 16, 16),
                                           ('spconv2', 16, 32),
                                           ('convout', 64, 128)])
def test_conv_backward_matches_jax_vjp(books, conv, cin, cout):
    rng = np.random.RandomState(4)
    key = 'spconv2' if conv == 'subm' else conv
    coords, mask, shape, _ = _level_of(books, key)
    feats = (rng.randn(*mask.shape, cin) * mask[..., None]).astype(np.float32)
    k = 27 if conv != 'convout' else 3
    w = (rng.randn(k, cin, cout) * 0.2).astype(np.float32)
    if conv == 'subm':
        rules, out_mask = books['port']['subm1'], torch.as_tensor(mask)
    else:
        _, _, out_mask, _, rules = books['port'][conv]
    g = rng.randn(*out_mask.shape, cout).astype(np.float32)
    out_j, df_j, dw_j = _jax_conv_vjp(books, conv, feats, coords, mask, shape,
                                      w, g)

    x = torch.as_tensor(feats).requires_grad_()
    wt = torch.as_tensor(w).requires_grad_()
    level = sparse.from_voxelizer(x, torch.as_tensor(coords),
                                  torch.as_tensor(mask), shape)
    if conv == 'subm':
        out = sparse.subm_conv3d(level, wt, rules, loads=sparse.ROWS,
                                 kw3=True)
    else:
        out = sparse.sparse_conv3d(level, wt, books['port'][conv],
                                   *_GEOM[conv][:3], loads=sparse.ROWS)
    df, dw = torch.autograd.grad(out.features, (x, wt), torch.as_tensor(g))
    _close(out.features.detach().numpy(), out_j)
    _close(df.numpy(), df_j)
    _close(dw.numpy(), dw_j)
    assert not df[~torch.as_tensor(mask)].any()

    x2 = torch.as_tensor(feats).requires_grad_()
    w2 = torch.as_tensor(w).requires_grad_()
    ref = _plain_autograd(x2, w2, rules, out_mask)
    df2, dw2 = torch.autograd.grad(ref, (x2, w2), torch.as_tensor(g))
    _close(df.numpy(), df2.numpy())
    _close(dw.numpy(), dw2.numpy())


def test_backward_skips_the_feature_gradient(books, monkeypatch):
    """A table with no gradient behind it (conv_input's) launches no
    feature-gradient gather-GEMM; the shared mirrored book is used as is."""
    calls = []
    real = sparse.gather_gemm

    def spy(*args, **kw):
        calls.append(kw.get('dgrad', False))
        return real(*args, **kw)
    monkeypatch.setattr(sparse, 'gather_gemm', spy)
    rng = np.random.RandomState(5)
    rules = books['port']['subm1']
    level = sparse.from_voxelizer(
        torch.as_tensor((rng.randn(2, CAP, 4) * books['mask'][..., None])
                        .astype(np.float32)),
        torch.as_tensor(books['coords']), torch.as_tensor(books['mask']),
        SHAPE)
    w = torch.as_tensor(rng.randn(27, 4, 16).astype(np.float32)
                        ).requires_grad_()
    out = sparse.subm_conv3d(level, w, rules, mirror=rules.flip(-1),
                             loads=sparse.ROWS, kw3=True)
    (dw,) = torch.autograd.grad(out.features.sum(), (w,))
    assert calls == [False] and dw.abs().sum() > 0


def _bn_inputs(masked):
    rng = np.random.RandomState(6 if masked else 7)
    if masked:
        x = rng.randn(2, 50, 8).astype(np.float32) * 2 + 0.5
        mask = np.zeros((2, 50), bool)
        mask[0, :31], mask[1, :12] = True, True
        return x, mask
    return rng.randn(2, 6, 5, 8).astype(np.float32) * 2 + 0.5, None


@pytest.mark.parametrize('masked', [True, False])
def test_train_batchnorm_matches_jax(masked):
    x, mask = _bn_inputs(masked)
    rng = np.random.RandomState(8)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    mean0 = rng.randn(8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    variables = {'params': {'scale': scale, 'bias': bias},
                 'batch_stats': {'mean': mean0, 'var': var0}}
    want, upd = TorchBatchNorm(8).apply(
        variables, jnp.asarray(x), True,
        mask=None if mask is None else jnp.asarray(mask),
        mutable=['batch_stats'])
    # the port's unmasked BN is NCHW (the RPN's layout); JAX's is NHWC
    bn = BatchNorm(8, channel_dim=-1 if masked else 1)
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(scale))
        bn.bias.copy_(torch.as_tensor(bias))
        bn.running_mean.copy_(torch.as_tensor(mean0))
        bn.running_var.copy_(torch.as_tensor(var0))
    bn.train()
    xt = torch.as_tensor(x if masked else np.transpose(x, (0, 3, 1, 2)))
    got = bn(xt, None if mask is None else torch.as_tensor(mask))
    if not masked:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6 * np.abs(want).max())
    stats = upd['batch_stats']
    np.testing.assert_allclose(bn.running_mean.numpy(), stats['mean'],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats['var'],
                               rtol=0, atol=1e-6)
    assert not np.allclose(stats['var'], var0)


def test_anchor_head_loss_matches_jax():
    cfg = tiny_second_cfg(num_class=3)
    head = cfg.MODEL.RPN.RPN_HEAD
    targets = AnchorHeadTargets(head.TARGET_CONFIG, np.array([128, 128, 16]),
                                list(cfg.CLASS_NAMES))
    a = targets.anchors.shape[0]
    apl = targets.num_anchors_per_location
    rng = np.random.RandomState(9)
    gts = []
    for b in range(2):
        n = 6
        boxes = np.stack([rng.uniform(2, 30, n), rng.uniform(-14, 14, n),
                          rng.uniform(-1.8, -1.0, n), rng.uniform(0.6, 2, n),
                          rng.uniform(0.8, 4.5, n), rng.uniform(1.4, 1.8, n),
                          rng.uniform(-np.pi, np.pi, n),
                          rng.randint(1, 4, n)], -1).astype(np.float32)
        gts.append(np.concatenate([boxes, np.zeros((4, 8), np.float32)]))
    assigned = [targets.assign(g) for g in gts]
    labels = np.stack([t['labels'] for t in assigned]).astype(np.int32)
    reg = np.stack([t['bbox_targets'] for t in assigned]).astype(np.float32)
    assert (labels > 0).sum() > 4 and (labels < 0).any()
    h = w = 16
    assert h * w * apl == a
    heads = {'box_preds': rng.randn(2, h, w, apl * 7),
             'cls_preds': rng.randn(2, h, w, apl * 3) - 2,
             'dir_cls_preds': rng.randn(2, h, w, apl * 2)}
    heads = {k: v.astype(np.float32) for k, v in heads.items()}
    lw = {'rpn_cls_weight': 1.0, 'rpn_loc_weight': 2.0, 'rpn_dir_weight': 0.2,
          'code_weights': [1.0] * 7}
    _, want = jax_rpn.anchor_head_loss(
        {k: jnp.asarray(v) for k, v in heads.items()},
        jnp.asarray(targets.anchors), jnp.asarray(labels), jnp.asarray(reg),
        num_class=3, loss_weights=lw, num_anchors_per_location=apl)
    _, got = anchor_head_loss(
        {k: torch.as_tensor(v) for k, v in heads.items()},
        torch.as_tensor(targets.anchors), torch.as_tensor(labels),
        torch.as_tensor(reg), num_class=3, loss_weights=lw)
    assert sorted(got) == sorted(want) == [
        'rpn_loss', 'rpn_loss_cls', 'rpn_loss_dir', 'rpn_loss_loc']
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_adam_onecycle_matches_optax():
    cfg, total = tiny_second_cfg(1).MODEL.TRAIN.OPTIMIZATION, 10
    tx, lr_sched = jax_opt.build_optimizer_and_schedule(cfg, total, 1)
    mom_sched = jax_opt.onecycle_mom_schedule(total, list(cfg.MOMS),
                                              float(cfg.PCT_START))
    rng = np.random.RandomState(10)
    params = {'a': rng.randn(3, 4).astype(np.float32),
              'b': rng.randn(5).astype(np.float32) * 0.1}
    state = tx.init(params)
    mine = [torch.as_tensor(params['a']).clone(),
            torch.as_tensor(params['b']).clone()]
    opt = optimization.AdamOneCycle.from_config(mine, cfg, total)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for step, size in enumerate((3.0, 40.0, 0.01, 12.0, 1.0)):
        grads = {'a': rng.randn(3, 4).astype(np.float32) * size,
                 'b': rng.randn(5).astype(np.float32) * size}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.as_tensor(grads['a']), torch.as_tensor(grads['b'])])
        np.testing.assert_allclose(mine[0].numpy(), jp['a'], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(mine[1].numpy(), jp['b'], rtol=0,
                                   atol=1e-6)
    assert opt.count == 5
    split = int(total * float(cfg.PCT_START))
    for step in (0, split, total):
        assert abs(opt.lr(step) - float(lr_sched(step))) <= 1e-7
        assert abs(opt.mom(step) - float(mom_sched(step))) <= 1e-7
    assert opt.lr(split) == pytest.approx(float(cfg.LR))


def test_voxel_overflow_counts_cells_past_the_cap():
    rng = np.random.RandomState(11)
    pts = rng.uniform([0, -8, -3, 0], [16, 8, 1, 1], (2, 600, 4)).astype(
        np.float32)
    mask = np.ones((2, 600), bool)
    mask[1, 300:] = False
    vs, pr = (0.5, 0.5, 4.0), (0, -8, -3, 16, 8, 1)
    out = voxelize_torch(torch.as_tensor(pts), torch.as_tensor(mask), vs, pr,
                         4, 200)
    for b in range(2):
        cells = np.floor((pts[b, mask[b], :3] - pr[:3]) / vs).astype(int)
        n = len(np.unique(cells, axis=0))
        assert int(out['voxel_overflow'][b]) == max(n - 200, 0)
    assert int(out['voxel_overflow'][0]) > 0


def test_float64_reference_path(books):
    """The plain versions take f64 on the CPU (chip_smoke.py's reference
    step): a subm conv's forward and backward in f64 agree with f32."""
    rng = np.random.RandomState(12)
    rules = books['port']['subm1']
    feats = (rng.randn(2, CAP, 16) * books['mask'][..., None])
    w = rng.randn(27, 16, 16) * 0.2
    g = rng.randn(2, CAP, 16)
    got = {}
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(feats, dtype=dtype).requires_grad_()
        wt = torch.as_tensor(w, dtype=dtype).requires_grad_()
        level = sparse.from_voxelizer(x, torch.as_tensor(books['coords']),
                                      torch.as_tensor(books['mask']), SHAPE)
        out = sparse.subm_conv3d(level, wt, rules, loads=sparse.ROWS,
                                 kw3=True)
        assert out.features.dtype == dtype
        got[dtype] = (out.features.detach(), *torch.autograd.grad(
            out.features, (x, wt), torch.as_tensor(g, dtype=dtype)))
    for a, b in zip(got[torch.float32], got[torch.float64]):
        _close(a.double().numpy(), b.numpy())
