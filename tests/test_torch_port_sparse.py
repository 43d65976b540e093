"""pcdet_tpu_torch sparse convolution vs pcdet_tpu (CPU, small levels).

- the plain versions of kernels B (f32) and C (bf16) against the Pallas
  kernels they replace, run in interpret mode (`_gather_matmul_fwd_only`,
  `_gather_matmul_packed_call` on pair-packed features), and against
  `_gm_any`'s CPU path;
- n_live gating: rows past it are zero, rows before it unchanged;
- `subm_conv3d` / `sparse_conv3d` over host books against
  `sparse.subm_conv3d_batched` / `sparse_conv3d_batched` (f32 and bf16),
  at the shapes of conv_input (K=27, 4->16), a strided conv (K=27, 16->32)
  and conv_out (K=3, 64->128);
- the book upload and decode against `host_books.unpack_books`;
- `resolve_caps` against `backbones3d._resolve_caps`.

Tolerance 1e-5 relative to max |out| for every conv, f32 and bf16 alike:
the bf16 products are exact in f32 on both sides, so only the order of the
f32 sums differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdet_tpu.models.backbones3d import _resolve_caps
from pcdet_tpu.ops import host_books as jax_books
from pcdet_tpu.ops import sparse as jax_sparse
from pcdet_tpu.ops.pallas import gather_gemm as gg
from pcdet_tpu_torch.models.backbones3d import resolve_caps
from pcdet_tpu_torch.ops import gather_gemm, host_books, sparse

torch.set_num_threads(1)

TOL = 1e-5
SHAPE = (9, 12, 14)
CAP = 256
CAPS = (128, 96, 64, 48)          # conv2 truncates: the drop counts differ
N_LIVE = (230, 150)
LAST_PAD = (1, 0, 0)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _coords(rng, n_live, cap, shape):
    coords = np.full((len(n_live), cap, 3), -1, np.int32)
    for b, n in enumerate(n_live):
        ids = np.sort(rng.choice(int(np.prod(shape)), n, replace=False))
        coords[b, :n] = np.stack([ids // (shape[1] * shape[2]),
                                  (ids // shape[2]) % shape[1],
                                  ids % shape[2]], axis=-1)
    return coords


def _feats(rng, mask, c):
    return (rng.randn(*mask.shape, c).astype(np.float32)
            * mask[..., None])


@pytest.fixture(scope='module')
def books():
    """Host books of a B=2 level (sorted coords, valid prefixes): the wire
    arrays, the JAX decode and the port's decode."""
    rng = np.random.RandomState(0)
    coords = _coords(rng, N_LIVE, CAP, SHAPE)
    mask = coords[..., 0] >= 0
    spec = jax_books.encoder_spec(SHAPE, CAPS, LAST_PAD)
    flat = jax_books.build_books_batch(coords, mask, SHAPE, spec)
    return {'coords': coords, 'mask': mask, 'spec': spec, 'flat': flat,
            'jax': jax_books.unpack_books(flat),
            'port': host_books.upload_books(flat, spec, CAP, 'cpu')}


def test_book_decode_matches_unpack_books(books):
    n_in = CAP
    for op in books['spec']:
        key = op[1]
        want, got = books['jax'][key], books['port'][key]
        if op[0] == 'subm':
            rows, found = (np.asarray(x) for x in want)
            np.testing.assert_array_equal(
                got.numpy(), np.where(found, rows, n_in))
            assert found.any() and not found.all()
            continue
        ids, crd, msk, drp, rows, found = (np.asarray(x) for x in want)
        g_ids, g_crd, g_msk, g_drp, g_rules = (x.numpy() for x in got)
        np.testing.assert_array_equal(g_ids, ids)
        np.testing.assert_array_equal(g_crd, crd)
        np.testing.assert_array_equal(g_msk, msk)
        np.testing.assert_array_equal(g_drp, drp)
        np.testing.assert_array_equal(g_rules, np.where(found, rows, n_in))
        assert g_rules.dtype == np.int32
        n_in = int(op[5])
    assert np.asarray(books['jax']['spconv2'][3]).max() > 0   # truncated


def test_numpy_book_builder_decodes_the_same(books, monkeypatch):
    """Without the native library, build_books_batch takes its numpy path;
    the port decodes its wire arrays to the same books."""
    from pcdet_tpu import native
    monkeypatch.setattr(native, 'get_lib', lambda: None)
    flat = jax_books.build_books_batch(books['coords'], books['mask'], SHAPE,
                                       books['spec'])
    port = host_books.upload_books(flat, books['spec'], CAP, 'cpu')
    for op in books['spec']:
        want, got = books['port'][op[1]], port[op[1]]
        if op[0] == 'subm':
            want, got = (want,), (got,)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def _table_and_rules(books, key, cin, seed):
    """A masked feature table with its zero row, (B, CAP+1, Cin), and the
    subm1 rules and live counts."""
    rng = np.random.RandomState(seed)
    feats = _feats(rng, books['mask'], cin)
    table = np.concatenate([feats, np.zeros((len(N_LIVE), 1, cin),
                                            np.float32)], axis=1)
    rules = books['port'][key].numpy()
    return table, rules, np.asarray(N_LIVE, np.int32)


@pytest.mark.parametrize('cin,cout', [(4, 16), (16, 32)])
def test_plain_b_matches_pallas_kernel(books, cin, cout, monkeypatch):
    monkeypatch.setattr(gg, 'INTERPRET', True)
    table, rules, n_live = _table_and_rules(books, 'subm1', cin, 1)
    rng = np.random.RandomState(2)
    w = rng.randn(27, cin, cout).astype(np.float32) * 0.2
    got = gather_gemm.gather_gemm(torch.as_tensor(table),
                                  torch.as_tensor(rules), torch.as_tensor(w),
                                  torch.as_tensor(n_live)).numpy()
    assert got.shape == (2, CAP, cout) and got.dtype == np.float32
    for b in range(2):
        args = (jnp.asarray(table[b]), jnp.asarray(rules[b]), jnp.asarray(w))
        kernel = gg._gather_matmul_fwd_only(*args, jnp.int32(n_live[b]))
        _close(got[b], kernel)
        _close(got[b], gg._gm_any(*args, n_live=jnp.int32(n_live[b])))


@pytest.mark.parametrize('cin,cout', [(4, 16), (16, 32)])
def test_plain_c_matches_packed_pallas_kernel(books, cin, cout,
                                              monkeypatch):
    monkeypatch.setattr(gg, 'INTERPRET', True)
    table, rules, n_live = _table_and_rules(books, 'subm1', cin, 3)
    rng = np.random.RandomState(4)
    w = rng.randn(27, cin, cout).astype(np.float32) * 0.2
    got = gather_gemm.gather_gemm(
        torch.as_tensor(table).to(torch.bfloat16), torch.as_tensor(rules),
        torch.as_tensor(w).to(torch.bfloat16),
        torch.as_tensor(n_live)).numpy()
    w_r = jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32)
    for b in range(2):
        fp, r = jnp.asarray(table[b]), jnp.asarray(rules[b])
        kernel = gg._gather_matmul_packed_call(
            gg.pack_bf16_pairs(fp), r, gg.split_weights_packed(w_r),
            jnp.int32(n_live[b]))
        _close(got[b], kernel)
        _close(got[b], gg._gm_any(fp, r, jnp.asarray(w), packed=True,
                                  n_live=jnp.int32(n_live[b])))
    # bf16 rounding is real: the f32 product differs by far more than TOL
    f32 = gather_gemm.gather_gemm(torch.as_tensor(table),
                                  torch.as_tensor(rules), torch.as_tensor(w),
                                  torch.as_tensor(n_live)).numpy()
    assert np.abs(f32 - got).max() > 100 * TOL * np.abs(f32).max()


@pytest.mark.parametrize('n_live', [0, 37, 230, CAP])
def test_n_live_gating(n_live):
    """Rows at or past n_live are zero even where their rules hit (random
    rules, no sorted prefix); rows before it are untouched."""
    rng = np.random.RandomState(5)
    b, v, k, cin, cout = 2, CAP, 27, 16, 32
    table = rng.randn(b, v + 1, cin).astype(np.float32)
    table[:, v] = 0
    rules = torch.as_tensor(rng.randint(0, v + 1, (b, v, k)).astype(np.int32))
    w = torch.as_tensor(rng.randn(k, cin, cout).astype(np.float32))
    table = torch.as_tensor(table)
    full = gather_gemm.gather_gemm(table, rules, w,
                                   torch.full((b,), v, dtype=torch.int32))
    live = torch.tensor([n_live, v], dtype=torch.int32)
    gated = gather_gemm.gather_gemm(table, rules, w, live)
    assert torch.equal(gated[0, :n_live], full[0, :n_live])
    assert not gated[0, n_live:].any()
    assert torch.equal(gated[1], full[1])
    assert full[0, n_live:].abs().sum() > 0 or n_live == v


def _levels(coords, mask, feats, shape):
    jax_level = jax_sparse.from_voxelizer(
        jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask), shape)
    port_level = sparse.from_voxelizer(
        torch.as_tensor(feats), torch.as_tensor(coords),
        torch.as_tensor(mask), shape)
    np.testing.assert_array_equal(port_level.ids.numpy(),
                                  np.asarray(jax_level.ids))
    return jax_level, port_level


def _conv4_level(books):
    """The level conv_out reads: spconv4's output set."""
    shape = SHAPE
    for op in books['spec']:
        if op[0] == 'spconv':
            shape = sparse.conv_out_shape(shape, *op[2:5])
            if op[1] == 'spconv4':
                _, crd, msk, _, _ = books['port']['spconv4']
                return crd.numpy(), msk.numpy(), shape
    raise AssertionError('spconv4 not in the spec')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('conv', ['conv_input', 'conv2_0', 'conv_out'])
def test_sparse_conv_matches_jax(books, conv, dtype):
    rng = np.random.RandomState(6)
    cd_jax = jnp.bfloat16 if dtype == 'bfloat16' else None
    cd = torch.bfloat16 if dtype == 'bfloat16' else None
    if conv == 'conv_out':
        coords, mask, shape = _conv4_level(books)
        cin, cout = 64, 128
        geom = ((3, 1, 1), (2, 1, 1), LAST_PAD)
    else:
        coords, mask, shape = books['coords'], books['mask'], SHAPE
        cin, cout = (4, 16) if conv == 'conv_input' else (16, 32)
        geom = ((3, 3, 3), (2, 2, 2), (1, 1, 1))
    feats = _feats(rng, mask, cin)
    k = int(np.prod(geom[0]))
    w = rng.randn(k, cin, cout).astype(np.float32) * 0.2
    jax_level, port_level = _levels(coords, mask, feats, shape)
    if conv == 'conv_input':
        want = jax_sparse.subm_conv3d_batched(
            jax_level, jnp.asarray(w), kernel=3, compute_dtype=cd_jax,
            book=books['jax']['subm1'])
        got = sparse.subm_conv3d(port_level, torch.as_tensor(w),
                                 books['port']['subm1'], cd,
                                 loads=sparse.ROWS, kw3=True)
    else:
        key = 'spconv2' if conv == 'conv2_0' else 'convout'
        cap = CAPS[0] if conv == 'conv2_0' else CAPS[3]
        want = jax_sparse.sparse_conv3d_batched(
            jax_level, jnp.asarray(w), kernel=geom[0], stride=geom[1],
            padding=geom[2], out_cap=cap, compute_dtype=cd_jax,
            book=books['jax'][key])
        got = sparse.sparse_conv3d(port_level, torch.as_tensor(w),
                                   books['port'][key], *geom, cd,
                                   loads=sparse.ROWS)
        np.testing.assert_array_equal(got.overflow.numpy(),
                                      np.asarray(want.overflow))
    assert got.shape == want.shape
    for name in ('ids', 'coords', 'mask'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.mask.any() and got.features.dtype == torch.float32
    _close(got.features.numpy(), want.features)
    assert not got.features[~got.mask].any()


def test_to_dense_matches_jax(books):
    rng = np.random.RandomState(7)
    feats = _feats(rng, books['mask'], 8)
    jax_level, port_level = _levels(books['coords'], books['mask'], feats,
                                    SHAPE)
    np.testing.assert_array_equal(
        sparse.to_dense(port_level).numpy(),
        np.asarray(jax_sparse.to_dense_batched(jax_level)))


@pytest.mark.parametrize('cap,absolute,frac', [
    (25088, (43520, 29184, 12288, 10240), (2.0, 1.6, 0.85, 0.7)),  # second
    (3000, (0, 0, 0), (0., 0., 0., 0.)),                            # tiny
    (16000, (0, 0, 0), (2.0, 1.6, 0.85, 0.7)),
    (5000, (43520, 0, 12288), (0., 1.6, 0.85, 0.7)),                # clamp
])
def test_resolve_caps_matches_jax(cap, absolute, frac):
    assert resolve_caps(cap, absolute, frac) == _resolve_caps(
        cap, absolute, frac, False)
