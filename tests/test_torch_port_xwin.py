"""pcdet_tpu_torch's x-window and segment loads (kernels E, E′, D″, D′) vs
pcdet_tpu (CPU, the tiny SECOND config).

- `sparse.xwin_selectors` equals `pcdet_tpu.ops.sparse._xwin_selectors` as
  integers on real host books of the tiny config (subm, strided, the
  mirrored subm book, the transposed strided book), drops no tap, and
  `rules_from_xwin` gives the book back; `mirror_xwin` equals the
  selectors of the mirrored book;
- `gather_xwin.segment_desc` equals `pcdet_tpu`'s `segment_desc` at tile 64
  with S 16 and 256, both branches populated;
- the plain versions of E, E′ (f32 and bf16) and D″, D′ equal the rows
  plain versions and JAX's CPU `_gm_any` / `_dw_any` to 1e-5 of max |ref|,
  and gate rows past n_live as the rows versions do;
- a conv whose kernel is 1 wide in x (subm or strided) stays on the rows
  kernels under window loads;
- at one 64-row tile, C = 8, S = 16, the Pallas kernels
  `_gather_matmul_xwin_call`, `_gather_matmul_seg_call`, `gather_dw_xwin`
  and `gather_dw_seg` in interpret mode against the port's plain versions;
- SECOND at the tiny config under loads (xwin, xwin) and (seg, seg):
  detect equals pcdet_tpu in counts and labels, boxes and scores to 1e-4;
  one train step's loss to 1e-5 relative and every gradient to 1e-4 of
  its largest value, as the rows loads do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_config import tiny_second_cfg

from pcdet_tpu.models.second import SECONDNet as JaxSECONDNet
from pcdet_tpu.ops import host_books as jax_books
from pcdet_tpu.ops import sparse as jax_sparse
from pcdet_tpu.ops.pallas import gather_gemm as gg
from pcdet_tpu.ops.voxelizer import voxelize_jnp
from pcdet_tpu_torch import detect
from pcdet_tpu_torch.datasets.synthetic import make_scene
from pcdet_tpu_torch.ops import gather_dw, gather_gemm, gather_xwin, sparse
from pcdet_tpu_torch.ops.voxelizer import grid_size
from pcdet_tpu_torch.train import train_state
from pcdet_tpu_torch.train.trainer import build_trainer
from pcdet_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

TOL = 1e-5
CLASSES = ['Car', 'Pedestrian', 'Cyclist']
LOADS = [sparse.Loads('xwin', 'xwin'), sparse.Loads('seg', 'seg')]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _scans(cfg, classes, num_objects):
    rng = np.random.RandomState(0)
    p = int(cfg.DATA_CONFIG.MAX_POINTS)
    g = int(cfg.DATA_CONFIG.MAX_GT_BOXES)
    points = np.zeros((2, p, 4), np.float32)
    mask = np.zeros((2, p), bool)
    gt = np.zeros((2, g, 8), np.float32)
    for i in range(2):
        pts, boxes, names = make_scene(rng, classes, num_objects=num_objects,
                                       x_range=(3, 30), y_range=(-14, 14))
        n = min(len(pts), p)
        points[i, :n], mask[i, :n] = pts[:n], True
        gt[i, :len(boxes), :7] = boxes
        gt[i, :len(boxes), 7] = [classes.index(x) + 1 for x in names]
    return points, mask, gt


@pytest.fixture(scope='module')
def tiny():
    """The tiny config's B2 books (eval caps), decoded on the CPU, with the
    zero-row index of each book's input level."""
    cfg = tiny_second_cfg(num_class=1)
    points, mask, _ = _scans(cfg, ['Car'], 4)
    det = detect.build_detector(cfg, 'cpu')
    vox = det.voxelize(torch.as_tensor(points), torch.as_tensor(mask))
    books = det.books(vox)
    cap = vox['coordinates'].shape[1]
    n_in, rules, masks = {}, {}, {}
    level_mask, level_n = vox['voxel_mask'], cap
    for op in det.model.host_book_spec(cap):
        key = op[1]
        if op[0] == 'subm':
            rules[key], n_in[key] = books[key], level_n
            masks[key] = (level_mask, level_mask)
            continue
        rules[key], n_in[key] = books[key][4], level_n
        masks[key] = (level_mask, books[key][2])
        level_mask, level_n = books[key][2], books[key][4].shape[1]
    return {'rules': rules, 'n_in': n_in, 'masks': masks}


def _book(tiny, key, kind):
    """(rules, n_in of the zero row, input mask, output mask) of a book: its
    forward rules, the mirrored subm book or the transposed strided book."""
    rules, n_in = tiny['rules'][key], tiny['n_in'][key]
    in_mask, out_mask = tiny['masks'][key]
    if kind == 'mirror':
        return rules.flip(-1), n_in, in_mask, out_mask
    if kind == 'transpose':
        n_out = rules.shape[1]
        return (sparse.transpose_rules(rules, n_in, n_out), n_out, out_mask,
                in_mask)
    return rules, n_in, in_mask, out_mask


BOOKS = [('subm1', 'fwd'), ('subm2', 'fwd'), ('subm4', 'fwd'),
         ('subm1', 'mirror'), ('subm3', 'mirror'), ('spconv2', 'fwd'),
         ('spconv3', 'fwd'), ('spconv4', 'fwd'), ('spconv2', 'transpose'),
         ('spconv4', 'transpose')]


@pytest.mark.parametrize('key,kind', BOOKS)
def test_xwin_selectors_match_jax(tiny, key, kind):
    rules, n_in, _, _ = _book(tiny, key, kind)
    base, sel, clamped = sparse.xwin_selectors(rules, n_in)
    assert int(clamped) == 0
    assert base.dtype == sel.dtype == torch.int32
    for b in range(rules.shape[0]):
        jb, js = jax_sparse._xwin_selectors(jnp.asarray(rules[b].numpy()),
                                            n_in)
        np.testing.assert_array_equal(base[b].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(sel[b].numpy(), np.asarray(js))
    assert torch.equal(sparse.rules_from_xwin(base, sel, n_in), rules)
    assert (sel != gather_xwin.NO_TAP).any() and (sel == gather_xwin.NO_TAP).any()
    if kind == 'fwd' and key.startswith('subm'):
        mb, ms, _ = sparse.xwin_selectors(rules.flip(-1), n_in)
        got_b, got_s = sparse.mirror_xwin(base, sel)
        assert torch.equal(got_b, mb) and torch.equal(got_s, ms)


def test_xwin_selectors_count_dropped_taps():
    """A found tap outside its group's 3-row window is counted and becomes
    a miss, as pcdet_tpu's clamp makes it one."""
    rules = torch.tensor([[[5, 6, 9], [2, 9, 5], [9, 9, 9]]], dtype=torch.int32)
    base, sel, clamped = sparse.xwin_selectors(rules, 9)
    assert int(clamped) == 1
    assert sel[0, :, 0].tolist() == [0 | 1 << 2 | 3 << 4, 0 | 3 << 2 | 3 << 4,
                                     0x3f]
    jb, js = jax_sparse._xwin_selectors(jnp.asarray(rules[0].numpy()), 9)
    np.testing.assert_array_equal(sel[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(base[0].numpy(), np.asarray(jb))


@pytest.mark.parametrize('s', [16, 256])
@pytest.mark.parametrize('key,kind', [('subm2', 'fwd'), ('spconv2', 'fwd'),
                                      ('spconv2', 'transpose')])
def test_segment_desc_matches_jax(tiny, key, kind, s):
    rules, n_in, _, _ = _book(tiny, key, kind)
    base, sel, _ = sparse.xwin_selectors(rules, n_in)
    anchor, ok, seloff = gather_xwin.segment_desc(base, sel, 64, s)
    v = base.shape[1]
    pad = (-v) % 64
    for b in range(base.shape[0]):
        bp = jnp.pad(jnp.asarray(base[b].numpy()), ((0, pad), (0, 0)))
        sp = jnp.pad(jnp.asarray(sel[b].numpy()), ((0, pad), (0, 0)),
                     constant_values=0x3f)
        ja, jo, js = gg.segment_desc(bp, sp, 64, s)
        np.testing.assert_array_equal(anchor[b].numpy(), np.asarray(ja))
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(jo))
        np.testing.assert_array_equal(seloff[b].numpy(), np.asarray(js)[:v])
    if s == 16 or (key, kind) != ('spconv2', 'fwd'):
        assert (ok == 1).any() and (ok == 0).any(), ok.float().mean()
    rebuilt = gather_xwin.rules_from_segment(anchor, ok, seloff, base, sel,
                                             n_in)
    assert torch.equal(rebuilt, rules)


def _gemm_inputs(tiny, key, kind, cin, cout, dtype, seed):
    rules, n_in, in_mask, out_mask = _book(tiny, key, kind)
    rng = np.random.RandomState(seed)
    b = rules.shape[0]
    table = np.zeros((b, n_in + 1, cin), np.float32)
    table[:, :n_in] = rng.randn(b, n_in, cin) * in_mask.numpy()[..., None]
    w = (rng.randn(rules.shape[2], cin, cout) * 0.2).astype(np.float32)
    n_live = out_mask.sum(1, dtype=torch.int32)
    return (torch.as_tensor(table).to(dtype), rules,
            torch.as_tensor(w).to(dtype), n_live, n_in)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('variant', ['xwin', 'seg'])
@pytest.mark.parametrize('key,kind,cin,cout', [
    ('subm2', 'fwd', 32, 32), ('spconv3', 'fwd', 32, 64),
    ('spconv3', 'transpose', 64, 32), ('subm3', 'fwd', 128, 64)])
def test_plain_forward_matches_rows_and_jax(tiny, variant, dtype, key, kind,
                                            cin, cout):
    feats, rules, w, n_live, n_in = _gemm_inputs(tiny, key, kind, cin, cout,
                                                 dtype, 1)
    base, sel, _ = sparse.xwin_selectors(rules, n_in)
    fn = (gather_xwin.gather_gemm_xwin if variant == 'xwin'
          else gather_xwin.gather_gemm_seg)
    full = torch.full_like(n_live, rules.shape[1])
    got = fn(feats, base, sel, w, full)
    assert got.dtype == torch.float32
    rows = gather_gemm.gather_gemm(feats, rules, w, full)
    _close(got.numpy(), rows.numpy())
    packed = dtype == torch.bfloat16
    for b in range(rules.shape[0]):
        want = gg._gm_any(jnp.asarray(feats[b].float().numpy()),
                          jnp.asarray(rules[b].numpy()),
                          jnp.asarray(w.float().numpy()), packed, True)
        _close(got[b].numpy(), np.asarray(want))
    mid = torch.minimum(n_live, torch.full_like(n_live, 64 * 3 + 21))
    for live in (n_live, mid, torch.zeros_like(n_live)):
        assert torch.equal(fn(feats, base, sel, w, live),
                           gather_gemm.gather_gemm(feats, rules, w, live))
    if variant == 'seg':             # the window branch on every tile
        assert torch.equal(gather_xwin.gather_gemm_seg(feats, base, sel, w,
                                                       full, s=2), got)


@pytest.mark.parametrize('variant', ['xwin', 'seg'])
@pytest.mark.parametrize('key,cin,cout', [('subm1', 16, 16),
                                          ('spconv2', 16, 32),
                                          ('subm3', 64, 64)])
def test_plain_dw_matches_rows_and_jax(tiny, variant, key, cin, cout):
    feats, rules, _, n_live, n_in = _gemm_inputs(tiny, key, 'fwd', cin, cout,
                                                 torch.float32, 2)
    rng = np.random.RandomState(3)
    g = torch.as_tensor(rng.randn(*rules.shape[:2], cout).astype(np.float32))
    base, sel, _ = sparse.xwin_selectors(rules, n_in)
    fn = (gather_dw.gather_dw_xwin if variant == 'xwin'
          else gather_dw.gather_dw_seg)
    full = torch.full_like(n_live, rules.shape[1])
    got = fn(feats, base, sel, g, full)
    assert got.shape == (27, cin, cout)
    _close(got.numpy(), gather_dw.gather_dw(feats, rules, g, full).numpy())
    want = sum(np.asarray(gg._dw_any(jnp.asarray(feats[b].numpy()),
                                     jnp.asarray(rules[b].numpy()),
                                     jnp.asarray(g[b].numpy()), True))
               for b in range(rules.shape[0]))
    _close(got.numpy(), want)
    mid = torch.minimum(n_live, torch.full_like(n_live, 64 * 2 + 13))
    for live in (n_live, mid):
        _close(fn(feats, base, sel, g, live).numpy(),
               gather_dw.gather_dw(feats, rules, g, live).numpy())
    assert not fn(feats, base, sel, g, torch.zeros_like(n_live)).any()


def test_cpu_paths_count_no_launch(tiny):
    feats, rules, w, n_live, n_in = _gemm_inputs(tiny, 'subm2', 'fwd', 32,
                                                 32, torch.float32, 4)
    before = (dict(gather_xwin.LAUNCHES), dict(gather_dw.LAUNCHES))
    base, sel, _ = sparse.xwin_selectors(rules, n_in)
    gather_xwin.gather_gemm_xwin(feats, base, sel, w, n_live)
    gather_xwin.gather_gemm_seg(feats, base, sel, w, n_live)
    g = torch.zeros(*rules.shape[:2], 32)
    gather_dw.gather_dw_xwin(feats, base, sel, g, n_live)
    gather_dw.gather_dw_seg(feats, base, sel, g, n_live)
    assert (gather_xwin.LAUNCHES, gather_dw.LAUNCHES) == before


@pytest.mark.parametrize('subm', [True, False])
def test_conv_not_3_wide_in_x_ignores_window_loads(monkeypatch, subm):
    """A conv whose kernel is 1 wide in x takes the rows kernels under any
    loads: its module passes kw3 from its kernel, so no selectors are built
    (grouping its taps by three would drop found taps) and its output and
    weight gradient are the rows loads'."""
    from pcdet_tpu_torch.models.backbones3d import SparseConv3d
    built = []
    real = sparse.xwin_selectors
    monkeypatch.setattr(sparse, 'xwin_selectors',
                        lambda *a: built.append(1) or real(*a))
    gen = torch.Generator().manual_seed(0)
    b, v_in, v_out, k = 2, 40, 40 if subm else 24, 9
    conv = SparseConv3d(4, 16, kernel=(3, 3, 1), padding=(1, 1, 0),
                        stride=(1, 1, 1) if subm else (2, 2, 1), subm=subm)
    conv.weight.data = torch.randn(conv.weight.shape, generator=gen)
    mask = torch.ones((b, v_in), dtype=torch.bool)
    mask[1, 30:] = False
    feats = torch.randn((b, v_in, 4), generator=gen) * mask[..., None]
    ids = torch.where(mask, torch.arange(v_in, dtype=torch.int32) * 7,
                      sparse.INT_MAX)
    level = sparse.SparseLevel(feats, ids, torch.zeros((b, v_in, 3),
                                                       dtype=torch.int32),
                               mask, (4, 16, 16))
    rules = torch.randint(0, v_in + 1, (b, v_out, k), generator=gen,
                          dtype=torch.int32)
    book = rules if subm else (ids[:, :v_out], level.coords[:, :v_out],
                               mask[:, :v_out], torch.zeros(b, dtype=torch.int32),
                               rules)
    got = {}
    for loads in (sparse.ROWS, sparse.Loads('xwin', 'seg'),
                  sparse.Loads('seg', 'xwin')):
        out = conv(level, book, None, loads)
        (dw,) = torch.autograd.grad(out.features.sum(), (conv.weight,))
        got[loads] = (out.features.detach(), dw)
    assert not built
    for out, dw in got.values():
        assert torch.equal(out, got[sparse.ROWS][0])
        assert torch.equal(dw, got[sparse.ROWS][1])


def test_wrappers_refuse_bad_inputs(tiny):
    feats, rules, w, n_live, n_in = _gemm_inputs(tiny, 'subm2', 'fwd', 32,
                                                 32, torch.float32, 5)
    base, sel, _ = sparse.xwin_selectors(rules, n_in)
    with pytest.raises(TypeError):                  # int64 selectors
        gather_xwin.gather_gemm_xwin(feats, base.long(), sel, w, n_live)
    with pytest.raises(ValueError):                 # weights of 26 taps
        gather_xwin.gather_gemm_xwin(feats, base, sel, w[:26], n_live)
    with pytest.raises(ValueError):                 # S beyond 10-bit offsets
        gather_xwin.gather_gemm_seg(feats, base, sel, w, n_live, s=1023)
    with pytest.raises(TypeError):                  # bf16 dW table
        gather_dw.gather_dw_seg(feats.bfloat16(), base, sel,
                                torch.zeros(*rules.shape[:2], 32), n_live)
    with pytest.raises(ValueError):                 # not contiguous
        gather_dw.gather_dw_xwin(feats, base[:, ::2], sel[:, ::2],
                                 torch.zeros(2, base[:, ::2].shape[1], 32),
                                 n_live)
    with pytest.raises(ValueError):
        sparse.Loads('rows', 'window').check()
    with pytest.raises(TypeError):                  # int64 rules
        sparse.xwin_selectors(rules.long(), n_in)
    with pytest.raises(ValueError):                 # not a multiple of 3 taps
        sparse.xwin_selectors(rules[..., :26].contiguous(), n_in)



@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cin,cout', gather_xwin.PAIRS)
def test_max_seg_rows_fits_a_block(dtype, cin, cout):
    """The most segment rows the card's E′ instance stages: its shared
    memory at 21 groups fits the 232,448 bytes of an sm_90 block and one
    row more would not (or the 10-bit limit 1022 binds), at least SEG_S,
    and the layout formula adds each staged row once per row stage (two,
    but one for f32 (128, 64) and (64, 128), whose 32 KB of W an x-tap
    then take a ring of two), at the row's bytes or 16 more."""
    limit = gather_xwin.max_seg_rows(dtype, cin, cout)
    groups = gather_xwin.MAX_GROUPS
    assert gather_xwin.SEG_S <= limit <= gather_xwin.SEG_MISS - 1
    assert gather_xwin.smem_bytes(dtype, cin, cout, limit, groups) \
        <= gather_xwin.SMEM_LIMIT == 232448
    if limit < gather_xwin.SEG_MISS - 1:
        assert gather_xwin.smem_bytes(dtype, cin, cout, limit + 1,
                                      groups) > gather_xwin.SMEM_LIMIT
    size = 2 if dtype == torch.bfloat16 else 4
    w_stages, row_stages = gather_xwin.stages(dtype, cin, cout)
    assert (w_stages, row_stages) == (
        (2, 1) if dtype == torch.float32 and (cin, cout) in ((128, 64),
                                                             (64, 128))
        else (3, 2))
    row = (gather_xwin.smem_bytes(dtype, cin, cout, 301, groups)
           - gather_xwin.smem_bytes(dtype, cin, cout, 300, groups)) \
        // row_stages
    assert row in (max(cin, 16 if size == 2 else 4) * size,
                   max(cin, 16 if size == 2 else 4) * size + 16)
    assert row % 16 == 0
    # windows take 192 rows: E and E′ at S <= 192 stage as many
    assert gather_xwin.smem_bytes(dtype, cin, cout, 0, 9) \
        == gather_xwin.smem_bytes(dtype, cin, cout, 192, 9) \
        < gather_xwin.smem_bytes(dtype, cin, cout, 193, 9)


def test_cpu_seg_takes_every_segment_size(tiny):
    """The plain version keeps taking S up to 1022, past what the card
    stages, as `pcdet_tpu`'s segment_desc does."""
    feats, rules, w, n_live, n_in = _gemm_inputs(tiny, 'subm2', 'fwd', 64,
                                                 64, torch.float32, 6)
    base, sel, _ = sparse.xwin_selectors(rules, n_in)
    assert gather_xwin.max_seg_rows(torch.float32, 64, 64) < 1022
    want = gather_xwin.gather_gemm_xwin(feats, base, sel, w, n_live)
    for s in (1, 1022):
        got = gather_xwin.gather_gemm_seg(feats, base, sel, w, n_live, s=s)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------- interpret mode ---

_ONE_TILE = 64
_C = 8
_SMALL_S = 16


@pytest.fixture(scope='module')
def one_tile():
    """A subm book of one 64-row tile whose groups populate both segment
    branches at S = 16, with its table, weights, g and selectors."""
    from pcdet_tpu_torch.ops import host_books
    rng = np.random.RandomState(11)
    shape = (5, 12, 24)
    ids = set()
    while len(ids) < _ONE_TILE:
        z, y, x = rng.randint(shape[0]), rng.randint(shape[1]), rng.randint(
            shape[2] - 4)
        for i in range(rng.randint(1, 5)):
            ids.add((z * shape[1] + y) * shape[2] + x + i)
    ids = np.sort(np.fromiter(ids, np.int64))[:_ONE_TILE]
    coords = np.stack([ids // (shape[1] * shape[2]),
                       (ids // shape[2]) % shape[1], ids % shape[2]],
                      -1).astype(np.int32)
    spec = host_books.encoder_spec(shape, (64, 64, 64, 64), (1, 0, 0))[:1]
    flat = host_books.build_books_batch(coords[None], np.ones((1, 64), bool),
                                        shape, spec)
    rules = host_books.upload_books(flat, spec, 64, 'cpu')['subm1']
    base, sel, clamped = sparse.xwin_selectors(rules, 64)
    assert int(clamped) == 0
    _, ok, _ = gather_xwin.segment_desc(base, sel, 64, _SMALL_S)
    assert (ok == 1).any() and (ok == 0).any()
    table = np.zeros((1, 65, _C), np.float32)
    table[0, :64] = rng.randn(64, _C)
    w = (rng.randn(27, _C, _C) * 0.2).astype(np.float32)
    g = rng.randn(1, 64, _C).astype(np.float32)
    return {'table': torch.as_tensor(table), 'w': torch.as_tensor(w),
            'g': torch.as_tensor(g), 'base': base, 'sel': sel,
            'rules': rules, 'n_live': torch.tensor([57], dtype=torch.int32)}


@pytest.mark.parametrize('kernel', ['E', 'E_bf16', "E'", "D''", "D'"])
def test_pallas_kernel_matches_port_plain(one_tile, kernel, monkeypatch):
    monkeypatch.setattr(gg, 'INTERPRET', True)
    monkeypatch.setattr(gg, 'TV', _ONE_TILE)
    monkeypatch.setattr(gg, 'SEG_S', _SMALL_S)
    t = one_tile
    table, w, g, base, sel, n_live = (t['table'], t['w'], t['g'], t['base'],
                                      t['sel'], t['n_live'])
    fp = jnp.asarray(table[0].numpy())
    jb, js = jnp.asarray(base[0].numpy()), jnp.asarray(sel[0].numpy())
    nl = jnp.int32(int(n_live[0]))
    pad = _SMALL_S - 1 if kernel in ("E'", "D'") else 1
    fp2 = jnp.concatenate([fp, jnp.zeros((pad, _C))], axis=0)
    if kernel == 'E':
        want = gg._gather_matmul_xwin_call(fp2, jb, js, gg.group_weights_x(
            jnp.asarray(w.numpy())), nl)
        got = gather_xwin.gather_gemm_xwin(table, base, sel, w, n_live)[0]
    elif kernel == 'E_bf16':
        w_r = jnp.asarray(w.numpy()).astype(jnp.bfloat16).astype(jnp.float32)
        want = gg._gather_matmul_xwin_call(
            gg.pack_bf16_pairs(fp2), jb, js, gg.group_weights_x_packed(w_r),
            nl)
        got = gather_xwin.gather_gemm_xwin(table.bfloat16(), base, sel,
                                           w.bfloat16(), n_live)[0]
    elif kernel == "E'":
        want = gg._gather_matmul_seg_call(fp2, jb, js, gg.group_weights_x(
            jnp.asarray(w.numpy())), nl)
        got = gather_xwin.gather_gemm_seg(table, base, sel, w, n_live,
                                          s=_SMALL_S)[0]
    else:
        # the Pallas dW gates whole tiles: rows past n_live get g = 0
        g_cut = g[0].numpy() * (np.arange(64) < int(n_live[0]))[:, None]
        fn = gg.gather_dw_seg if kernel == "D'" else gg.gather_dw_xwin
        want = fn(fp2, jb, js, jnp.asarray(g_cut), nl)
        if kernel == "D'":
            got = gather_dw.gather_dw_seg(table, base, sel, g, n_live,
                                          s=_SMALL_S)
        else:
            got = gather_dw.gather_dw_xwin(table, base, sel, g, n_live)
    want = np.asarray(want)
    if kernel.startswith('E'):       # the Pallas forward leaves dead rows be
        want = want * (np.arange(64) < int(n_live[0]))[:, None]
    _close(got.numpy(), want)


# ------------------------------------------------ SECOND under loads ---

def _random_variables(template, seed, zero_cls_bias):
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        names = [getattr(p, 'key', '') for p in path]
        if names[-1] == 'kernel':
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if zero_cls_bias and names[-1] == 'bias' and 'conv_cls' in names:
            return np.zeros(leaf.shape, np.float32)
        if names[-1] in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


def _jax_batch(cfg, points, mask, train):
    dc = cfg.DATA_CONFIG
    vs = tuple(dc.VOXEL_GENERATOR.VOXEL_SIZE)
    pr = tuple(dc.POINT_CLOUD_RANGE)
    cap = int((dc.TRAIN if train else dc.TEST).MAX_NUMBER_OF_VOXELS)
    jmodel = JaxSECONDNet(cfg, grid_size(vs, pr))
    vox = jax.vmap(lambda q, m: voxelize_jnp(
        q, m, vs, pr, int(dc.VOXEL_GENERATOR.MAX_POINTS_PER_VOXEL), cap))(
            jnp.asarray(points), jnp.asarray(mask))
    batch = {'voxels': vox['voxels'], 'num_points': vox['num_points_per_voxel'],
             'coordinates': vox['coordinates'],
             'voxel_mask': vox['voxel_mask']}
    template = jax.eval_shape(
        lambda: jmodel.init_variables(jax.random.PRNGKey(0), batch))
    flat = jax_books.build_books_batch(
        np.asarray(vox['coordinates']), np.asarray(vox['voxel_mask']),
        jmodel.sparse_shape, jmodel.host_book_spec(cap, train))
    batch.update({k: jnp.asarray(v) for k, v in flat.items()})
    return jmodel, batch, template


@pytest.fixture(scope='module')
def detect_ref():
    cfg = tiny_second_cfg(num_class=1)
    points, mask, _ = _scans(cfg, ['Car'], 4)
    jmodel, batch, template = _jax_batch(cfg, points, mask, False)
    variables = _random_variables(template, 0, True)
    ret, _ = jmodel.forward(variables, batch, train=False)
    want = {k: np.asarray(v) for k, v in jmodel.predict(ret).items()}
    assert (want['num'] > 0).all()
    return cfg, points, mask, variables, want


@pytest.mark.parametrize('loads', LOADS, ids=lambda x: '%s-%s' % x)
def test_detect_matches_jax_under_loads(detect_ref, loads):
    cfg, points, mask, variables, want = detect_ref
    det = detect.build_detector(cfg, 'cpu', seed=0, loads=loads)
    assert det.model.module.rpn_net.loads == loads
    det.model.module.load_state_dict(state_dict_from_flax(
        variables, cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']))
    got = {k: v.numpy() for k, v in det.detect(
        torch.as_tensor(points), torch.as_tensor(mask)).items()}
    clamped = det.model.module.rpn_net.xwin_clamped
    assert len(clamped) == 7 and all(int(c) == 0 for c in clamped.values())
    np.testing.assert_array_equal(got['num'], want['num'])
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    np.testing.assert_allclose(got['boxes'], want['boxes'], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got['scores'], want['scores'], rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope='module')
def train_ref():
    cfg = tiny_second_cfg(num_class=3)
    points, mask, gt = _scans(cfg, CLASSES, 6)
    jmodel, jbatch, template = _jax_batch(cfg, points, mask, True)
    variables = _random_variables(template, 1, False)
    targets = [jmodel.anchor_targets.assign(g) for g in gt]
    jbatch['box_cls_labels'] = jnp.asarray(np.stack(
        [t['labels'] for t in targets]).astype(np.int32))
    jbatch['box_reg_targets'] = jnp.asarray(np.stack(
        [t['bbox_targets'] for t in targets]).astype(np.float32))

    def loss_fn(params, overflow):
        b = dict(jbatch, voxel_overflow=overflow)
        ret, _ = jmodel.forward(
            {'params': params, 'batch_stats': variables['batch_stats']},
            b, train=True)
        return jmodel.loss(ret, b)[0]

    return cfg, points, mask, gt, variables, jax.jit(jax.value_and_grad(
        loss_fn))


@pytest.mark.parametrize('loads', LOADS, ids=lambda x: '%s-%s' % x)
def test_train_step_matches_jax_under_loads(train_ref, loads):
    cfg, points, mask, gt, variables, loss_and_grad = train_ref
    trainer = build_trainer(cfg, 'cpu', seed=0, total_steps=10, loads=loads)
    layer_nums = cfg.MODEL.RPN.RPN_HEAD.ARGS['layer_nums']
    trainer.model.module.load_state_dict(state_dict_from_flax(variables,
                                                              layer_nums))
    batch = trainer.make_batch(torch.as_tensor(points), torch.as_tensor(mask),
                               gt)
    loss, (jgrads) = loss_and_grad(variables['params'], jnp.asarray(
        batch['voxel_overflow'].numpy()))
    got_loss, _, got_grads = train_state.loss_and_grads(
        trainer.model, trainer.state.params, batch)
    clamped = trainer.model.module.rpn_net.xwin_clamped
    assert len(clamped) == 10 and all(int(c) == 0 for c in clamped.values())
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    want = state_dict_from_flax({'params': jgrads}, layer_nums)
    names = [n for n, _ in trainer.model.module.named_parameters()]
    for name, g in zip(names, got_grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)
