"""pcdet_tpu_torch kernels on the card: kernel vs its plain version.

Marked `gpu`; each test skips without a CUDA device (the kernels have no
CPU mode).  On a machine with a card, run without the JAX suite's conftest
(this file imports only torch and the port):

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Rotated overlap (kernel A): bitwise equal to the plain version on every
pair (`torch.equal`; --fmad=false, and the pairs it culls are +0.0 in the
plain version too), two launches equal, its count of pairs kept (not
culled) equal to the plain predicate `overlap_maybe_nonzero_plain`'s, on
random boxes, shapes at the tiles' ragged edges (32 columns, 8-32 rows), a
recall grid with zero-padded rows (one-point quads), crafted pairs and
near misses at the cull gap.
Gather-GEMM (kernels B and C): 1e-5 of max |plain|; the kernel and the
plain version (cuBLAS) may sum in different orders at these small shapes.
B keeps its tap-major, channel-inner `fmaf` order; C sums on the tensor
cores in their order; both are bitwise repeatable (two launches equal), on
n_live at, one row short of and one row past the instance's row tile, with
taps that miss in every row of a tile (skipped), K 1 to 64.  dW (kernel
D): 1e-5 of max |plain| at these short sums (chip_smoke.py holds the
full-size sums to 1e-4), and two launches bitwise equal, on books that find
60%, 8% or none of their taps, each with a sub-tile where no tap is found
and a tap no row finds, K 1 to 64, every (Cin, Cout) instance.  The sparse convs' autograd backward on the
card (kernels B over the mirrored / transposed books, D) against the same
backward on the CPU (plain versions): 1e-5 of max |grad|.  The x-window
and segment kernels (E, E′ in f32 and bf16, D″, D′) against their plain
versions on selectors of window-structured books, windows running up to
the table's last row, all-miss rows, n_live none / mid-tile / all: E, E′
1e-5 and D″, D′ 1e-5 of max |plain| (short sums; also on selectors
finding 60%, 8% or none of their x-taps), E, E′ bitwise equal to kernel B
(f32) or C (bf16) on the same book, E, E′, D″, D′ bitwise repeatable, E′
and D′ counting each (tile, group) on the branch the segment descriptors
give, E′ at the most segment rows the card stages (`max_seg_rows`) and
refusing one more; the selector kernel equal to its plain version
as integers, dropped taps counted; the convs' backward under each `Loads`
on the card against the CPU.  Kernel A″ (the sorted-candidate overlap)
bitwise equal to its plain version on random and crafted boxes, the B8
recall grid with zero-padded rows, degenerate quads and the crafted quads
of the CPU test of its compacted order, and with NaN and Inf corners and
finite corners whose products overflow (areas of +inf and NaN; NaN equal
to NaN), two launches bitwise equal, one launch counted per call,
bad operands refused; `boxes_iou3d_batched` through one
launch of kernel A equal to its plain version on the card and within 1e-5
of the CPU (sin / cos round differently on the two devices).  The CLI pair
on a KITTI-format tree (`chip_smoke.write_kitti_tree`): train on the card,
then the evaluation of its checkpoint, recall through kernel A; the
loader's batches from forked workers, with CUDA up in the parent, equal to
the thread workers' bit for bit.  Two PartA2.yaml train steps at B2
through kernels B, D, D′ (the decoder's pairs among them) and A, with fg
RoIs and their regression losses.  Two gloo ranks spawned on the card
against one process on it (`ddp_ranks.py`; chip_smoke.py M1 at the tiny
SECOND widths), with per-rank and with synced BatchNorm.  The rulebooks
built on the card (`host_books.build_books_device`, under torch.cuda's
sync debug mode 'error') equal to the host books, outputs dropped at small
caps; `SparseBottleneck` (4 launches of B) and `sparse_maxpool3d` on the
card against the CPU.  `utils.profiler.trace` records kernel A on the
card.  On two cards or more (the `two_cards` tests skip below two): every
kernel with its operands on cuda:1, launched from a thread on cuda:0,
bitwise equal to cuda:0 (chip_smoke.py M4 (a)); kernel A″'s blocks an SM
on cuda:1 equal whichever card a process asks first; the two-rank step
over NCCL, one rank a card; synced BatchNorm over NCCL with no host sync
(torch.cuda's sync debug mode 'error'); the test CLI at `--device cuda:1`
equal to cuda:0's, nothing allocated on cuda:0.
"""
import itertools

import numpy as np
import pytest
import torch

from pcdet_tpu.ops import host_books as np_books
from pcdet_tpu_torch.ops import (gather_dw, gather_gemm, gather_xwin,
                                 host_books, nms, rotated_iou,
                                 rotated_overlap, sparse)

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def _boxes5(rng, shape, spread=20.0):
    cx = rng.uniform(-spread, spread, shape)
    cy = rng.uniform(-spread, spread, shape)
    w = rng.uniform(0.5, 5.0, shape)
    l = rng.uniform(0.5, 7.0, shape)
    ang = rng.uniform(-np.pi, np.pi, shape)
    return np.stack([cx - w / 2, cy - l / 2, cx + w / 2, cy + l / 2, ang],
                    axis=-1).astype(np.float32)


def _check_kernel_a(ca, cb):
    """Kernel A bitwise equal to plain on every pair, two launches equal,
    its count of pairs kept equal to the plain predicate's, one launch
    counted per call."""
    before = rotated_overlap.LAUNCHES
    got = rotated_overlap.pair_overlap_batched(ca, cb)
    assert rotated_overlap.LAUNCHES == before + 1
    again, count = rotated_overlap.pair_overlap_batched_counted(ca, cb)
    want = rotated_overlap.pair_overlap_batched_plain(ca, cb)
    kept = rotated_overlap.overlap_maybe_nonzero_plain(ca.cpu(), cb.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()
    assert torch.equal(got, again)
    assert int(count) == int(kept.sum())
    return got, kept


@pytest.mark.parametrize('g,m,n', [(2, 64, 4096), (3, 37, 1000), (1, 5, 7),
                                   (2, 33, 31), (1, 32, 33), (2, 65, 97)])
def test_kernel_matches_plain(cuda, g, m, n):
    rng = np.random.RandomState(0)
    cb = rotated_iou.boxes5_to_corners(
        torch.as_tensor(_boxes5(rng, (g, n)), device=cuda)).contiguous()
    ca = (cb[:, :m] if m <= n else rotated_iou.boxes5_to_corners(
        torch.as_tensor(_boxes5(rng, (g, m)), device=cuda))).contiguous()
    _check_kernel_a(ca, cb)


def test_kernel_on_recall_grid_with_zero_rows(cuda):
    """The B8 recall grid: 500 predictions x 128 GT a sample, zero-padded
    rows in both (one-point quads, on which the plain version returns the
    other box's whole area): every pair with one is kept."""
    import chip_smoke
    preds, gt = (torch.as_tensor(x, device=cuda) for x in
                 chip_smoke.recall_grid_boxes7(np.random.RandomState(7)))
    got, kept = _check_kernel_a(rotated_iou.boxes7_to_corners(preds),
                                rotated_iou.boxes7_to_corners(gt))
    zero_a = (preds == 0).all(-1).cpu()
    zero_b = (gt == 0).all(-1).cpu()
    assert bool(kept[zero_a].all()) and bool(kept.transpose(1, 2)[zero_b].all())
    assert bool((got.cpu()[zero_b[:, None].expand(-1, 500, -1)
                           & ~zero_a[..., None]] > 0).all())


def test_kernel_on_crafted_pairs_and_near_misses(cuda):
    """chip_smoke's crafted pairs (identical, contained, edge-sharing,
    disjoint) and near misses placed just past and inside the cull gap at
    every angle, with slivers."""
    import chip_smoke
    a, b = (rotated_iou.boxes5_to_corners(torch.as_tensor(x, device=cuda))
            for x in chip_smoke.crafted_boxes5())
    got, _ = _check_kernel_a(a[None].contiguous(), b[None].contiguous())
    torch.testing.assert_close(
        torch.diagonal(got[0]).cpu(), torch.tensor([4.0, 0, 0, 100, 100, 8]),
        rtol=1e-5, atol=2e-5)
    a, b = (torch.as_tensor(x, device=cuda) for x in
            chip_smoke.near_miss_pairs(np.random.RandomState(8), 32, 2048))
    _, kept = _check_kernel_a(a, b)
    assert int((~kept).sum()) > 0


def _sorted_grid(case, dev):
    """(corners_a, corners_b) of a case of `test_sorted_kernel_matches_plain`
    on `dev`."""
    import chip_smoke
    if case.startswith('random'):
        g, m, n = (int(x) for x in case.split()[1].split('x'))
        rng = np.random.RandomState(5)
        cb = rotated_iou.boxes5_to_corners(
            torch.as_tensor(_boxes5(rng, (g, n)), device=dev)).contiguous()
        return cb[:, :m].contiguous(), cb
    if case == 'B8 recall grid':
        return tuple(rotated_iou.boxes7_to_corners(torch.as_tensor(
            x, device=dev)) for x in chip_smoke.recall_grid_boxes7(
                np.random.RandomState(7)))
    if case == 'degenerate quads':
        rng = np.random.RandomState(5)
        cb = rotated_iou.boxes5_to_corners(
            torch.as_tensor(_boxes5(rng, (2, 4096)), device=dev)).contiguous()
        return chip_smoke.degenerate_quads(cb[:, :64].contiguous(), cb)
    quads = np.concatenate(list(chip_smoke.sorted_crafted_quads().values()))
    quads = torch.as_tensor(quads, device=dev)[None].contiguous()
    if case == 'crafted quads':
        return quads, quads
    a, b = quads.clone(), quads.clone()             # 'non-finite corners'
    a[0, 3, 1, 0] = float('nan')
    b[0, 7, 2, 1] = float('inf')
    b[0, 9, 0, 0] = float('-inf')
    # and finite corners whose products overflow: areas of +inf and NaN
    over = torch.as_tensor(chip_smoke.overflow_quads(), device=dev)[None]
    return torch.cat([a, over], 1), torch.cat([b, over], 1)


@pytest.mark.parametrize('case', ['random 2x64x4096', 'random 3x37x1000',
                                  'random 1x5x7', 'B8 recall grid',
                                  'degenerate quads', 'crafted quads',
                                  'non-finite corners'])
def test_sorted_kernel_matches_plain(cuda, case):
    """Kernel A″ bitwise equal to its plain version on random boxes, the B8
    recall grid with zero-padded rows on both sides (one-point quads),
    the NMS shape with degenerate quads, the CPU test's crafted quads
    (`chip_smoke.sorted_crafted_quads`, every ordered pair) and with NaN
    and Inf corners and corners whose products overflow (areas of +inf
    and NaN; NaN equal to NaN); two launches equal."""
    ca, cb = _sorted_grid(case, cuda)
    before = rotated_overlap.LAUNCHES_SORTED
    got = rotated_overlap.pair_overlap_sorted_batched(ca, cb)
    assert rotated_overlap.LAUNCHES_SORTED == before + 1
    again = rotated_overlap.pair_overlap_sorted_batched(ca, cb)
    want = rotated_overlap.pair_overlap_sorted_plain(ca, cb)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    if case == 'non-finite corners':
        assert want.isnan().any() and want.isposinf().any()
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    else:
        assert torch.equal(got, want), (got - want).abs().max().item()
    assert (want > 0).sum() > 0


def test_sorted_kernel_crafted_pairs(cuda):
    a = np.array([[-5, -5, 5, 5, 0.0]] * 5 + [[0, 0, 2, 4, 0.7]], np.float32)
    b = np.array([[-1, -1, 1, 1, 0.9], [5, -1, 7, 1, 0.0],
                  [100, 100, 102, 102, 0.3], [-5, -5, 5, 5, np.pi / 2],
                  [-5, -5, 5, 5, 0.0], [0, 0, 2, 4, 0.7]], np.float32)
    ca = rotated_iou.boxes5_to_corners(torch.as_tensor(a, device=cuda))
    cb = rotated_iou.boxes5_to_corners(torch.as_tensor(b, device=cuda))
    got = rotated_overlap.pair_overlap_sorted(ca.contiguous(), cb.contiguous())
    want = rotated_overlap.pair_overlap_sorted_plain(ca[None], cb[None])[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(
        torch.diagonal(got).cpu(), torch.tensor([4.0, 0, 0, 100, 100, 8]),
        rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'groups', 'strides',
                                 'device'])
def test_sorted_kernel_rejects_bad_input(cuda, bad):
    c = torch.zeros(2, 8, 4, 2, device=cuda)
    a, b = c[:, :4].contiguous(), c
    if bad == 'device':                   # one operand on the CPU
        a = a.cpu()
    elif bad == 'dtype':
        a = a.double()
    elif bad == 'shape':
        a = a.reshape(2, 4, 8)
    elif bad == 'groups':
        a = a[:1]
    else:
        a = torch.zeros(2, 4, 2, 4, device=cuda).transpose(2, 3)
    before = rotated_overlap.LAUNCHES_SORTED
    with pytest.raises((TypeError, ValueError)):
        rotated_overlap.pair_overlap_sorted_batched(a, b)
    assert rotated_overlap.LAUNCHES_SORTED == before


def test_boxes_iou3d_batched_through_kernel_a(cuda):
    rng = np.random.RandomState(6)
    boxes = np.concatenate([rng.uniform(-20, 20, (3, 500, 2)),
                            rng.uniform(-2, 0, (3, 500, 1)),
                            rng.uniform(0.5, 4.5, (3, 500, 3)),
                            rng.uniform(-np.pi, np.pi, (3, 500, 1))],
                           -1).astype(np.float32)
    a = torch.as_tensor(boxes, device=cuda)
    b = a[:, :128] + 0.1
    before = rotated_overlap.LAUNCHES
    got = rotated_iou.boxes_iou3d_batched(a, b)
    assert rotated_overlap.LAUNCHES == before + 1
    plain = rotated_iou.boxes_iou3d_batched(
        a, b, rotated_overlap.pair_overlap_batched_plain)
    cpu = rotated_iou.boxes_iou3d_batched(a.cpu(), b.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    torch.testing.assert_close(got.cpu(), cpu, rtol=0, atol=1e-5)
    assert (cpu > 0.5).sum() > 300


def test_kernel_rejects_non_contiguous(cuda):
    c = torch.zeros(2, 8, 4, 2, device=cuda)
    with pytest.raises(ValueError):
        rotated_overlap.pair_overlap_batched(c[:, ::2], c)


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'groups', 'strides',
                                 'device'])
def test_kernel_rejects_bad_input(cuda, bad):
    c = torch.zeros(2, 8, 4, 2, device=cuda)
    a, b = c[:, :4].contiguous(), c
    if bad == 'device':                   # one operand on the CPU
        a = a.cpu()
    elif bad == 'dtype':
        a = a.double()
    elif bad == 'shape':
        a = a.reshape(2, 4, 8)
    elif bad == 'groups':
        a = a[:1]
    else:
        a = torch.zeros(2, 4, 2, 4, device=cuda).transpose(2, 3)
    before = rotated_overlap.LAUNCHES
    for fn in (rotated_overlap.pair_overlap_batched,
               rotated_overlap.pair_overlap_batched_counted):
        with pytest.raises((TypeError, ValueError)):
            fn(a, b)
    assert rotated_overlap.LAUNCHES == before


@pytest.mark.parametrize('rotated', [True, False])
def test_nms_gpu_matches_cpu(cuda, rotated):
    rng = np.random.RandomState(1)
    g, a = 3, 2000
    boxes = torch.as_tensor(np.stack([_boxes5(rng, a, 15.0)
                                      for _ in range(g)]))
    scores = torch.as_tensor(rng.randn(g, a).astype(np.float32))
    valid = torch.as_tensor(rng.rand(g, a) > 0.1)
    want = nms.nms_bev_batched(boxes, scores, 0.1, pre_max=1024,
                               post_max=300, valid_mask=valid,
                               rotated=rotated)
    got = nms.nms_bev_batched(boxes.to(cuda), scores.to(cuda), 0.1,
                              pre_max=1024, post_max=300,
                              valid_mask=valid.to(cuda), rotated=rotated)
    for w, x in zip(want, got):
        torch.testing.assert_close(x.cpu(), w, rtol=0, atol=0)


@pytest.fixture
def no_tf32():
    """The plain version's matmul in full f32 on the card."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _gg_inputs(rng, b, v_in, v_out, k, cin, cout, dtype, device,
               skip_rows=0):
    """A table (row v_in zero), rules with misses and an all-miss row 5,
    weights; taps k // 2 .. k - 1 miss in every one of the first
    `skip_rows` rows (a tile whose kernel skips them; all its taps at
    K = 1)."""
    table = rng.randn(b, v_in + 1, cin).astype(np.float32)
    table[:, v_in] = 0
    rules = rng.randint(0, v_in + 1, (b, v_out, k)).astype(np.int32)
    rules[rng.rand(b, v_out, k) < 0.4] = v_in                # misses
    rules[:, 5] = v_in                                        # an all-miss row
    rules[:, :skip_rows, k // 2:] = v_in
    w = rng.randn(k, cin, cout).astype(np.float32) * 0.2
    return (torch.as_tensor(table, device=device).to(dtype),
            torch.as_tensor(rules, device=device),
            torch.as_tensor(w, device=device).to(dtype))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k,cin,cout', list(itertools.product(
    (27, 3, 1, 64), gather_gemm.CIN, gather_gemm.COUT)))
def test_gather_gemm_matches_plain(cuda, no_tf32, dtype, k, cin, cout):
    rng = np.random.RandomState(k * 1000 + cin * 10 + cout)
    tile = gather_gemm.tile_rows(dtype, cin, cout)  # 64, 128 or 256 rows
    v_in, v_out = 300, 2 * tile + 72  # not a multiple of the tile
    name = ('gather_gemm_bf16' if dtype == torch.bfloat16
            else 'gather_gemm_f32')
    for b in (1, 3):
        feats, rules, w = _gg_inputs(rng, b, v_in, v_out, k, cin, cout,
                                     dtype, cuda, skip_rows=tile)
        full = torch.full((b,), v_out, dtype=torch.int32, device=cuda)
        scale = gather_gemm.gather_gemm_plain(feats, rules, w,
                                              full).abs().max().item()
        assert scale > 0
        # none, mid-tile, all; at a tile edge and one row either side
        for live in (0, 100, v_out, tile - 1, tile, tile + 1):
            n_live = torch.full((b,), live, dtype=torch.int32, device=cuda)
            if b > 1:
                n_live[-1] = v_out                 # samples gate apart
            before = gather_gemm.LAUNCHES[name]
            got = gather_gemm.gather_gemm(feats, rules, w, n_live)
            again = gather_gemm.gather_gemm(feats, rules, w, n_live)
            assert gather_gemm.LAUNCHES[name] == before + 2
            want = gather_gemm.gather_gemm_plain(feats, rules, w, n_live)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert torch.equal(got, again)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
            assert not got[0, live:].any()
            assert not got[:, 5].any()


def test_gather_gemm_rejects_bad_inputs(cuda):
    rng = np.random.RandomState(0)
    feats, rules, w = _gg_inputs(rng, 2, 50, 40, 27, 16, 32, torch.float32,
                                 cuda)
    n_live = torch.full((2,), 40, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):                  # f64 features
        gather_gemm.gather_gemm(feats.double(), rules, w.double(), n_live)
    with pytest.raises(TypeError):                  # f32 feats, bf16 weights
        gather_gemm.gather_gemm(feats, rules, w.bfloat16(), n_live)
    with pytest.raises(TypeError):                  # int64 rules
        gather_gemm.gather_gemm(feats, rules.long(), w, n_live)
    with pytest.raises(ValueError):                 # no instance for Cin 8
        gather_gemm.gather_gemm(feats[..., :8].contiguous(), rules,
                                w[:, :8].contiguous(), n_live)
    with pytest.raises(ValueError):                 # K of rules != K of W
        gather_gemm.gather_gemm(feats, rules[..., :3].contiguous(), w, n_live)
    with pytest.raises(ValueError):                 # rules on the host
        gather_gemm.gather_gemm(feats, rules.cpu(), w, n_live)
    with pytest.raises(ValueError):                 # not contiguous
        gather_gemm.gather_gemm(feats, rules[:, ::2], w, n_live)
    shifted = torch.empty(feats.numel() + 1, device=cuda)[1:]
    with pytest.raises(ValueError):                 # 4 bytes off 16
        gather_gemm.gather_gemm(shifted.view_as(feats), rules, w, n_live)


# share of (row, tap) rules that miss: SECOND's books find about a third of
# their taps; a sparse book finds at most a tenth, an empty one none
_MISSES = {'dense': 0.4, 'sparse': 0.92, 'empty': 1.0}


def _dw_inputs(rng, b, v_in, v_out, k, cin, cout, device, misses=0.4):
    table = rng.randn(b, v_in + 1, cin).astype(np.float32)
    table[:, v_in] = 0
    rules = rng.randint(0, v_in + 1, (b, v_out, k)).astype(np.int32)
    rules[rng.rand(b, v_out, k) < misses] = v_in              # misses
    rules[:, 64:128] = v_in            # a sub-tile where no tap is found
    if k > 1:
        rules[:, :, k // 2] = v_in     # a tap no row finds
    g = rng.randn(b, v_out, cout).astype(np.float32)
    return (torch.as_tensor(table, device=device),
            torch.as_tensor(rules, device=device),
            torch.as_tensor(g, device=device))


@pytest.mark.parametrize('books', list(_MISSES))
@pytest.mark.parametrize('k,cin,cout', [(k, *p) for k in (27, 3, 1, 64)
                                        for p in gather_dw.PAIRS])
def test_gather_dw_matches_plain(cuda, no_tf32, books, k, cin, cout):
    rng = np.random.RandomState(k * 1000 + cin * 10 + cout)
    v_in, v_out = 300, 200                         # 200 = 3 tiles + 8 rows
    for b in (1, 3):
        feats, rules, g = _dw_inputs(rng, b, v_in, v_out, k, cin, cout, cuda,
                                     _MISSES[books])
        for live in (0, 100, v_out):               # none, mid-tile, all
            n_live = torch.full((b,), live, dtype=torch.int32, device=cuda)
            if b > 1:
                n_live[-1] = v_out                 # samples gate apart
            before = gather_dw.LAUNCHES['gather_dw']
            got = gather_dw.gather_dw(feats, rules, g, n_live)
            again = gather_dw.gather_dw(feats, rules, g, n_live)
            assert gather_dw.LAUNCHES['gather_dw'] == before + 2
            want = gather_dw.gather_dw_plain(feats, rules, g, n_live)
            torch.cuda.synchronize()
            assert got.shape == (k, cin, cout) and got.dtype == torch.float32
            assert torch.equal(got, again)
            if not want.any():
                assert not got.any()
                continue
            scale = want.abs().max().item()
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


def test_gather_dw_rejects_bad_inputs(cuda):
    rng = np.random.RandomState(0)
    feats, rules, g = _dw_inputs(rng, 2, 50, 40, 27, 16, 32, cuda)
    n_live = torch.full((2,), 40, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                 # no (16, 64) instance
        gather_dw.gather_dw(feats, rules, torch.cat([g, g], -1), n_live)
    with pytest.raises(ValueError):                 # K = 65
        gather_dw.gather_dw(feats, torch.cat([rules] * 3, -1)[..., :65]
                            .contiguous(), g, n_live)
    with pytest.raises(TypeError):                  # bf16 table
        gather_dw.gather_dw(feats.bfloat16(), rules, g, n_live)
    with pytest.raises(ValueError):                 # g on the host
        gather_dw.gather_dw(feats, rules, g.cpu(), n_live)
    with pytest.raises(ValueError):                 # not contiguous
        gather_dw.gather_dw(feats, rules[:, ::2], g[:, ::2], n_live)


def _sorted_coords(rng, n_live, cap, shape):
    coords = np.full((len(n_live), cap, 3), -1, np.int32)
    for b, n in enumerate(n_live):
        ids = np.sort(rng.choice(int(np.prod(shape)), n, replace=False))
        coords[b, :n] = np.stack([ids // (shape[1] * shape[2]),
                                  (ids // shape[2]) % shape[1],
                                  ids % shape[2]], axis=-1)
    return coords


@pytest.mark.parametrize('conv,cin,cout', [('subm', 16, 16),
                                           ('spconv2', 16, 32),
                                           ('convout', 64, 128)])
def test_conv_backward_on_card_matches_cpu(cuda, no_tf32, conv, cin, cout):
    """RulebookConv's backward on CUDA (B over the mirrored or transposed
    book, D) equals its backward on the CPU (the plain versions)."""
    rng = np.random.RandomState(1)
    shape, cap = (5, 40, 40), 600
    coords = _sorted_coords(rng, (560, 410), cap, shape)
    mask = coords[..., 0] >= 0
    spec = np_books.encoder_spec(shape, (640, 512, 384, 320), (1, 0, 0))
    flat = np_books.build_books_batch(coords, mask, shape, spec)
    if conv == 'convout':                       # conv_out reads spconv4's set
        _, crd, msk, _, _ = host_books.upload_books(flat, spec, cap,
                                                    'cpu')['spconv4']
        coords, mask = crd.numpy(), msk.numpy()
        for op in spec[:6]:
            if op[0] == 'spconv':
                shape = sparse.conv_out_shape(shape, *op[2:5])
    feats = (rng.randn(*mask.shape, cin) * mask[..., None]).astype(np.float32)
    k = 3 if conv == 'convout' else 27
    w = (rng.randn(k, cin, cout) * 0.2).astype(np.float32)
    out_rows = {'subm': mask.shape[1], 'spconv2': 640, 'convout': 320}[conv]
    g = rng.randn(2, out_rows, cout).astype(np.float32)
    grads = {}
    for dev in ('cpu', cuda):
        books = host_books.upload_books(flat, spec, cap, dev)
        x = torch.as_tensor(feats, device=dev).requires_grad_()
        wt = torch.as_tensor(w, device=dev).requires_grad_()
        level = sparse.from_voxelizer(x, torch.as_tensor(coords, device=dev),
                                      torch.as_tensor(mask, device=dev),
                                      shape)
        if conv == 'subm':
            out = sparse.subm_conv3d(level, wt, books['subm1'],
                                     loads=sparse.ROWS, kw3=True)
        elif conv == 'spconv2':
            out = sparse.sparse_conv3d(level, wt, books['spconv2'], 3, 2, 1,
                                       loads=sparse.ROWS)
        else:
            out = sparse.sparse_conv3d(level, wt, books['convout'],
                                       (3, 1, 1), (2, 1, 1), (1, 0, 0),
                                       loads=sparse.ROWS)
        before = (gather_gemm.LAUNCHES['gather_gemm_f32_dgrad'],
                  gather_dw.LAUNCHES['gather_dw'])
        gx, gw = torch.autograd.grad(out.features, (x, wt),
                                     torch.as_tensor(g, device=dev))
        after = (gather_gemm.LAUNCHES['gather_gemm_f32_dgrad'],
                 gather_dw.LAUNCHES['gather_dw'])
        assert after == (before if torch.device(dev).type == 'cpu' else
                         (before[0] + 1, before[1] + 1))
        grads[str(dev)] = (gx.cpu(), gw.cpu())
    for got, want in zip(grads[str(cuda)], grads['cpu']):
        scale = want.abs().max().item()
        assert scale > 0
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


def _xwin_inputs(rng, b, v_in, v_out, g, cin, cout, device, misses=None):
    """A table, window selectors (bases ascending along the rows, as a
    sorted book's are; some windows end at or past the last row; rows 5
    and 6 all-miss; with `misses`, that share of the x-taps missing, the
    second 64-row sub-tile finding none and x-tap 1 of group 0 none in any
    row), weights and an output gradient."""
    table = rng.randn(b, v_in + 1, cin).astype(np.float32)
    table[:, v_in] = 0
    base = np.sort(rng.randint(0, v_in - 2, (b, v_out, g)), axis=1)
    off = rng.randint(0, 4, (b, v_out, g, 3))
    base[:, -3:] = v_in - 1                  # window rows v_in - 1 .. v_in + 1
    off[:, -3:] = [0, 3, 3]
    if misses is not None:
        off[rng.rand(b, v_out, g, 3) < misses] = 3
        off[:, 64:128] = 3
        off[:, :, 0, 1] = 3
    sel = off[..., 0] | (off[..., 1] << 2) | (off[..., 2] << 4)
    sel[:, 5:7], base[:, 5:7] = 0x3f, 0
    w = rng.randn(3 * g, cin, cout).astype(np.float32) * 0.2
    grad = rng.randn(b, v_out, cout).astype(np.float32)
    return [torch.as_tensor(x, device=device) for x in (
        table, base.astype(np.int32), sel.astype(np.int32), w, grad)]


_VARIANTS = [('xwin', 0), ('seg', gather_xwin.SEG_S), ('seg', 16)]


@pytest.mark.parametrize('books', [None] + list(_MISSES))
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('variant,s', _VARIANTS)
@pytest.mark.parametrize('cin,cout', gather_xwin.PAIRS)
def test_gather_gemm_window_matches_plain(cuda, no_tf32, variant, s, dtype,
                                         cin, cout, books):
    """E / E′ within 1e-5 of the plain version, bitwise equal to kernel B
    (f32) or C (bf16) on the same book as rules and to a second launch, the
    card's (tile, group) tally equal to the 64-row descriptors'; V_out 200
    is ragged against every block, and with `books` a 64-row tile finds no
    group and x-tap 1 of group 0 no row."""
    rng = np.random.RandomState(cin * 10 + cout + s)
    v_in, v_out = 300, 200
    for b in (1, 3):
        table, base, sel, w, _ = _xwin_inputs(
            rng, b, v_in, v_out, 9, cin, cout, cuda,
            books and _MISSES[books])
        table, w = table.to(dtype), w.to(dtype)
        rules = gather_xwin.rules_from_xwin(base, sel, v_in)
        if variant == 'xwin':
            fn, plain = gather_xwin.gather_gemm_xwin, \
                gather_xwin.gather_gemm_xwin_plain
        else:
            def fn(*a):
                return gather_xwin.gather_gemm_seg(*a, s=s)

            def plain(*a):
                return gather_xwin.gather_gemm_seg_plain(*a, s=s)
        key = 'gather_gemm_%s_%s' % (variant, 'bf16' if dtype == torch.bfloat16
                                     else 'f32')
        for live in (0, 100, v_out):
            n_live = torch.full((b,), live, dtype=torch.int32, device=cuda)
            if b > 1:
                n_live[-1] = v_out
            gather_xwin.reset_seg_tiles()
            before = gather_xwin.LAUNCHES[key]
            got = fn(table, base, sel, w, n_live)
            assert gather_xwin.LAUNCHES[key] == before + 1
            tiles = gather_xwin.seg_tiles()
            again = fn(table, base, sel, w, n_live)
            rows = gather_gemm.gather_gemm(table, rules, w, n_live)
            want = plain(table, base, sel, w, n_live)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert torch.equal(got, again)
            assert torch.equal(got, rows)
            if not want.any():
                assert not got.any()
            else:
                scale = want.abs().max().item()
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=1e-5 * scale)
            assert not got[0, live:].any() and not got[:, 5:7].any()
            if variant == 'seg':
                _, ok, _ = gather_xwin.segment_desc(base, sel, 64, s)
                reach = ((torch.arange(ok.shape[1], device=cuda) * 64)[None]
                         < n_live[:, None])[..., None]
                assert tiles == {'segment': int(((ok > 0) & reach).sum()),
                                 'window': int(((ok == 0) & reach).sum())}
            else:
                assert tiles == {'segment': 0, 'window': 0}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cin,cout', gather_xwin.PAIRS)
def test_gather_gemm_seg_rows_the_card_stages(cuda, no_tf32, dtype, cin,
                                              cout):
    """`max_seg_rows` equals the kernel's own limit; E′ runs at it (bitwise
    equal to kernel B / C) and the wrapper refuses one row more."""
    limit = gather_xwin.max_seg_rows(dtype, cin, cout)
    assert limit >= gather_xwin.SEG_S
    assert limit == gather_xwin.build().pcdet_gather_gemm_xwin_max_seg_rows(
        int(dtype == torch.bfloat16), cin, cout)
    rng = np.random.RandomState(cin + cout)
    v_in, v_out = 300, 200
    table, base, sel, w, _ = _xwin_inputs(rng, 2, v_in, v_out, 9, cin, cout,
                                          cuda)
    table, w = table.to(dtype), w.to(dtype)
    n_live = torch.full((2,), v_out, dtype=torch.int32, device=cuda)
    got = gather_xwin.gather_gemm_seg(table, base, sel, w, n_live, s=limit)
    rows = gather_gemm.gather_gemm(
        table, gather_xwin.rules_from_xwin(base, sel, v_in), w, n_live)
    torch.cuda.synchronize()
    assert torch.equal(got, rows)
    if limit < gather_xwin.SEG_MISS - 1:
        with pytest.raises(ValueError, match='at most %d' % limit):
            gather_xwin.gather_gemm_seg(table, base, sel, w, n_live,
                                        s=limit + 1)


@pytest.mark.parametrize('books', [None] + list(_MISSES))
@pytest.mark.parametrize('variant,s', _VARIANTS)
@pytest.mark.parametrize('cin,cout', gather_dw.XWIN_PAIRS)
def test_gather_dw_window_matches_plain(cuda, no_tf32, books, variant, s, cin,
                                        cout):
    rng = np.random.RandomState(cin * 10 + cout + s + 1)
    v_in, v_out = 300, 200
    for b in (1, 3):
        table, base, sel, _, grad = _xwin_inputs(
            rng, b, v_in, v_out, 9, cin, cout, cuda,
            books and _MISSES[books])
        if variant == 'xwin':
            fn, plain = gather_dw.gather_dw_xwin, gather_dw.gather_dw_xwin_plain
        else:
            def fn(*a):
                return gather_dw.gather_dw_seg(*a, s=s)

            def plain(*a):
                return gather_dw.gather_dw_seg_plain(*a, s=s)
        key = 'gather_dw_' + variant
        for live in (0, 100, v_out):
            n_live = torch.full((b,), live, dtype=torch.int32, device=cuda)
            if b > 1:
                n_live[-1] = v_out
            before = gather_dw.LAUNCHES[key]
            got = fn(table, base, sel, grad, n_live)
            again = fn(table, base, sel, grad, n_live)
            assert gather_dw.LAUNCHES[key] == before + 2
            want = plain(table, base, sel, grad, n_live)
            torch.cuda.synchronize()
            assert got.shape == (27, cin, cout) and got.dtype == torch.float32
            assert torch.equal(got, again)
            if not want.any():
                assert not got.any()
                continue
            scale = want.abs().max().item()
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize('cin,cout', gather_dw.XWIN_PAIRS)
def test_gather_dw_seg_rows_the_card_stages(cuda, no_tf32, cin, cout):
    """`gather_dw.max_seg_rows` (and `row_stages`, `smem_bytes`) mirror the
    kernel: D′ holds a block at that many segment rows and not at one
    more; D′ there is within 1e-4 of plain, and the wrapper refuses one
    row more."""
    limit = gather_dw.max_seg_rows(cin, cout)
    assert limit >= gather_xwin.SEG_S
    lib = gather_dw.build_xwin()
    assert lib.pcdet_gather_dw_xwin_resident(1, cin, cout, limit) > 0
    if limit < gather_xwin.SEG_MISS - 1:
        assert lib.pcdet_gather_dw_xwin_resident(1, cin, cout, limit + 1) < 0
    rng = np.random.RandomState(cin + cout)
    table, base, sel, _, grad = _xwin_inputs(rng, 2, 300, 200, 9, cin, cout,
                                             cuda)
    n_live = torch.full((2,), 200, dtype=torch.int32, device=cuda)
    got = gather_dw.gather_dw_seg(table, base, sel, grad, n_live, s=limit)
    want = gather_dw.gather_dw_seg_plain(table.cpu(), base.cpu(), sel.cpu(),
                                         grad.cpu(), n_live.cpu(), s=limit)
    scale = want.abs().max().item()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * scale)
    if limit < gather_xwin.SEG_MISS - 1:
        with pytest.raises(ValueError, match='at most %d' % limit):
            gather_dw.gather_dw_seg(table, base, sel, grad, n_live,
                                    s=limit + 1)


@pytest.mark.parametrize('b,v,g', [(1, 5, 1), (2, 300, 9), (3, 1000, 9)])
def test_xwin_selectors_kernel_matches_plain(cuda, b, v, g):
    """Rules with found taps in and out of their 3-row window and misses."""
    rng = np.random.RandomState(b * 100 + v)
    n_in = 5000
    start = rng.randint(0, n_in - 6, (b, v, g, 1))
    rules = start + rng.randint(0, 3, (b, v, g, 3))
    rules[rng.rand(b, v, g, 3) < 0.4] = n_in                 # misses
    far = rng.rand(b, v, g, 3) < 0.05                        # out of window
    rules[far] = np.minimum(start + 3 + rng.randint(0, 3, far.shape),
                            n_in - 1)[far]
    rules = torch.as_tensor(rules.reshape(b, v, 3 * g).astype(np.int32),
                            device=cuda)
    before = gather_xwin.LAUNCHES['xwin_selectors']
    got = gather_xwin.xwin_selectors(rules, n_in)
    assert gather_xwin.LAUNCHES['xwin_selectors'] == before + 1
    want = gather_xwin.xwin_selectors_plain(rules, n_in)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert int(got[2]) > 0 or v < 10


def test_window_kernels_reject_bad_inputs(cuda):
    rng = np.random.RandomState(0)
    table, base, sel, w, grad = _xwin_inputs(rng, 2, 50, 40, 9, 16, 32, cuda)
    n_live = torch.full((2,), 40, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):                  # f64 on the card
        gather_xwin.gather_gemm_xwin(table.double(), base, sel, w.double(),
                                     n_live)
    with pytest.raises(ValueError):                 # no (16, 128) instance
        gather_xwin.gather_gemm_seg(table, base, sel,
                                    torch.cat([w] * 4, -1), n_live)
    with pytest.raises(ValueError):                 # no (16, 128) dW instance
        gather_dw.gather_dw_xwin(table, base, sel, torch.cat([grad] * 4, -1),
                                 n_live)
    with pytest.raises(ValueError):                 # selectors on the host
        gather_dw.gather_dw_seg(table, base.cpu(), sel.cpu(), grad, n_live)


@pytest.mark.parametrize('loads', [sparse.Loads('xwin', 'xwin'),
                                   sparse.Loads('seg', 'seg'),
                                   sparse.Loads('xwin', 'seg')])
@pytest.mark.parametrize('conv,cin,cout', [('subm', 16, 16),
                                           ('spconv2', 16, 32)])
def test_window_conv_backward_on_card_matches_cpu(cuda, no_tf32, loads, conv,
                                                  cin, cout):
    """RulebookConv under window loads: forward, feature gradient (E / E′
    over the mirrored or transposed book) and dW (D″ / D′) on the card equal
    the CPU's plain versions."""
    rng = np.random.RandomState(2)
    shape, cap = (5, 40, 40), 600
    coords = _sorted_coords(rng, (560, 410), cap, shape)
    mask = coords[..., 0] >= 0
    spec = np_books.encoder_spec(shape, (640, 512, 384, 320), (1, 0, 0))
    flat = np_books.build_books_batch(coords, mask, shape, spec)
    feats = (rng.randn(*mask.shape, cin) * mask[..., None]).astype(np.float32)
    w = (rng.randn(27, cin, cout) * 0.2).astype(np.float32)
    g = rng.randn(2, cap if conv == 'subm' else 640, cout).astype(np.float32)
    out = {}
    for dev in ('cpu', cuda):
        books = host_books.upload_books(flat, spec, cap, dev)
        x = torch.as_tensor(feats, device=dev).requires_grad_()
        wt = torch.as_tensor(w, device=dev).requires_grad_()
        level = sparse.from_voxelizer(x, torch.as_tensor(coords, device=dev),
                                      torch.as_tensor(mask, device=dev),
                                      shape)
        if conv == 'subm':
            y = sparse.subm_conv3d(level, wt, books['subm1'], loads=loads,
                                   kw3=True)
        else:
            y = sparse.sparse_conv3d(level, wt, books['spconv2'], 3, 2, 1,
                                     loads=loads)
        gx, gw = torch.autograd.grad(y.features, (x, wt),
                                     torch.as_tensor(g, device=dev))
        out[str(dev)] = (y.features.detach().cpu(), gx.cpu(), gw.cpu())
    for got, want in zip(out[str(cuda)], out['cpu']):
        scale = want.abs().max().item()
        assert scale > 0
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


# PointPillar training on the card (chip_smoke.py P2 and P4 at a smaller
# grid: pointpillar.yaml's widths with 0.32 m pillars, 216 x 248, and a
# 4000-pillar train cap)

@pytest.fixture
def no_tf32_conv(no_tf32):
    """f32 convolutions in full f32 on the card, as chip_smoke.py sets."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = old


def _small_pointpillar_cfg():
    from pcdet_tpu_torch import detect
    cfg = detect.load_config()
    cfg.DATA_CONFIG.VOXEL_GENERATOR.VOXEL_SIZE = [0.32, 0.32, 4]
    cfg.DATA_CONFIG.TRAIN.MAX_NUMBER_OF_VOXELS = 4000
    cfg.DATA_CONFIG.TEST.MAX_NUMBER_OF_VOXELS = 4000
    return cfg


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_pointpillar_train_step_on_card_matches_cpu(cuda, no_tf32_conv,
                                                    dtype):
    """One B1 step from the same weights and scan: the loss (f32 1e-4
    relative, f64 1e-9) and in f64 every gradient (1e-9 of max)."""
    from pcdet_tpu_torch.train import train_state
    from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans
    cfg = _small_pointpillar_cfg()
    pts, mask, gt = make_train_scans(cfg, 1)
    out = {}
    for dev in ('cpu', cuda):
        tr = build_trainer(cfg, dev, seed=0, total_steps=10)
        tr.model.module.to(dtype)
        batch = tr.make_batch(torch.as_tensor(pts, device=dev),
                              torch.as_tensor(mask, device=dev), gt)
        for key in ('voxels', 'box_reg_targets'):
            batch[key] = batch[key].to(dtype)
        loss, _, grads = train_state.loss_and_grads(tr.model, tr.state.params,
                                                    batch)
        out[str(dev)] = (float(loss), [g.cpu() for g in grads])
    (lc, gc), (lg, gg) = out['cpu'], out[str(cuda)]
    tol = 1e-4 if dtype == torch.float32 else 1e-9
    assert abs(lg - lc) <= tol * abs(lc), (lg, lc)
    if dtype == torch.float64:
        for a, b in zip(gg, gc):
            scale = b.abs().max().item()
            assert (a - b).abs().max().item() <= 1e-9 * scale


def test_parta2_train_steps_on_card(cuda, no_tf32_conv):
    """Two PartA2.yaml steps at B2 on the card (4000 train voxels, the
    UNet's caps by their fractions), the last 4 RoI slots a sample given
    to moved and grown GT boxes (`chip_smoke.parta2_gt_proposals`): finite
    loss terms, fg RoIs taken in every sample and a regression and corner
    loss on them, and
    per step 28 forward and 27 feature-gradient launches of kernel B, 27
    of D′ (among them the decoder's (128, 64), (64, 32) and (32, 16)), 1
    of D, and kernel A in the proposal NMS and the sampler."""
    import chip_smoke
    from pcdet_tpu_torch import detect
    from pcdet_tpu_torch.ops import rotated_overlap
    from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans
    cfg = detect.load_config(detect.PARTA2_CFG)
    cfg.DATA_CONFIG.TRAIN.MAX_NUMBER_OF_VOXELS = 4000
    pts, mask, gt = make_train_scans(cfg, 2, ring_keep=0.35)
    trainer = build_trainer(cfg, cuda, seed=0, total_steps=10)
    batch = trainer.make_batch(torch.as_tensor(pts, device=cuda),
                               torch.as_tensor(mask, device=cuda), gt)
    chip_smoke.parta2_gt_proposals(trainer.model, batch['gt_boxes'])
    counters = (gather_gemm.LAUNCHES, gather_dw.LAUNCHES)
    before = [dict(c) for c in counters]
    pairs = dict(gather_dw.PAIR_LAUNCHES)
    a0 = rotated_overlap.LAUNCHES
    tbs, samplers = [], []
    for _ in range(2):
        tbs.append(trainer.step(batch))
        samplers.append(dict(trainer.model.last_sampler))
    torch.cuda.synchronize()
    grown = {k: c[k] - b.get(k, 0) for c, b in zip(counters, before)
             for k in c if c[k] != b.get(k, 0)}
    assert grown == {'gather_gemm_f32': 56, 'gather_gemm_f32_dgrad': 54,
                     'gather_dw': 2, 'gather_dw_seg': 54}, grown
    for cin, cout in ((128, 64), (64, 32), (32, 16)):
        key = ('gather_dw_seg', cin, cout)
        assert gather_dw.PAIR_LAUNCHES.get(key, 0) - pairs.get(key, 0) == 4
    assert rotated_overlap.LAUNCHES - a0 > 2
    for tb, sampler in zip(tbs, samplers):
        assert all(torch.isfinite(v).all() for v in tb.values())
        assert 'rcnn_loss_cls' in tb and 'rpn_loss_u_cls' in tb
        assert int(sampler['fg_count'].min()) > 0, sampler['fg_count']
        assert tb['rcnn_loss_reg'] > 0 and tb['rcnn_loss_corner'] > 0


@pytest.mark.parametrize('mode', ['per_rank', 'sync'])
def test_two_gloo_ranks_on_card_match_one_process(cuda, no_tf32_conv,
                                                  tmp_path, mode):
    """chip_smoke.py M1 at the tiny SECOND widths (`tests/tiny_config.py`,
    3 classes): a global batch of 2 over two gloo ranks spawned on the one
    card (each with its own BN statistics, or synced) against one process
    on the card (bn_groups 2, or one group), through kernels B and D: the
    summed loss within 1e-4 relative, every summed gradient within 1e-3 of
    max (the tolerance chip_smoke.py T4 holds the kernels to against plain)
    and the BN running statistics too, kernels B and D launched on both
    ranks, and after 3 steps both ranks' states bitwise equal."""
    _ranks_match_one_process(tmp_path, mode, 'cuda:0', 'cuda:0', 'gloo')


def _ranks_match_one_process(tmp_path, mode, ref_device, rank_device,
                             backend):
    """The tiny SECOND step over two ranks (`rank_device`: one device for
    both, or one card a rank) against one process on `ref_device`."""
    import ddp_ranks
    from tiny_config import tiny_second_cfg
    from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans
    cfg = ddp_ranks.port_cfg(tiny_second_cfg(num_class=3))
    cfg.DATA_CONFIG.MAX_GT_BOXES = 32
    points, mask, gt = make_train_scans(cfg, 2, num_objects=6)
    job = {'cfg': cfg, 'state': build_trainer(cfg, 'cpu', seed=1).model
           .module.state_dict(), 'points': points, 'mask': mask, 'gt': gt,
           'sync_bn': mode == 'sync', 'device': ref_device}
    want = ddp_ranks.step_job(job, bn_groups=2 if mode == 'per_rank' else 1)
    per_rank = isinstance(rank_device, (list, tuple))
    got = [r[0] for r in ddp_ranks.run_ranks(
        tmp_path, ddp_ranks.step_rank,
        [dict(job, steps=3, device='card' if per_rank else rank_device)],
        device=rank_device, backend=backend)]
    for r in got:
        assert abs(r['loss'] - want['loss']) <= 1e-4 * abs(want['loss'])
        for n, g in want['grads'].items():
            assert ddp_ranks.max_rel_err(r['grads'][n], g) <= 1e-3, n
        for n, v in want['stats'].items():
            assert ddp_ranks.max_rel_err(r['stats'][n], v) <= 1e-3, n
        assert r['launches'].get('gather_gemm_f32', 0) > 0
        assert r['launches'].get('gather_gemm_f32_dgrad', 0) > 0
        assert r['launches'].get('gather_dw', 0) > 0
    (s0, c0), (s1, c1) = got[0]['state'], got[1]['state']
    assert c0 == c1 == (3, 3)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_train_model_checkpoint_eval_on_card(cuda, tmp_path):
    """2 epochs of train_model on the card, the latest checkpoint restored
    bitwise into a trainer of other weights, a detector built from it
    detecting as the trained module does (its recall through kernel A)."""
    from pcdet_tpu_torch import detect
    from pcdet_tpu_torch.models import detector3d
    from pcdet_tpu_torch.train import checkpoint
    from pcdet_tpu_torch.train.train_loop import train_model
    from pcdet_tpu_torch.train.trainer import TrainScans, build_trainer
    cfg = _small_pointpillar_cfg()
    scans = TrainScans(cfg, 4, 2)
    trainer = build_trainer(cfg, cuda, seed=0, iters_each_epoch=len(scans),
                            epochs=2)
    with torch.no_grad():
        trainer.model.module.rpn_head.conv_cls.bias.zero_()
    train_model(trainer, scans, 2, ckpt_save_dir=tmp_path)
    path = checkpoint.latest_checkpoint(tmp_path)
    assert path.endswith('checkpoint_epoch_2.pth')
    restored = build_trainer(cfg, cuda, seed=1, iters_each_epoch=len(scans),
                             epochs=2)
    assert checkpoint.restore_train_state(path, restored.state)[1] == 2
    live, back = trainer.state.state_dict(), restored.state.state_dict()
    assert back['it'] == live['it'] == 4
    for k, v in live['model_state'].items():
        assert torch.equal(back['model_state'][k], v), k
    for slot, d in live['optimizer_state']['state'].items():
        for k, v in d.items():
            assert torch.equal(back['optimizer_state']['state'][slot][k], v)
    det = detect.build_detector(cfg, cuda, checkpoint=path)
    points, pmask, gt = next(iter(scans))
    pts = torch.as_tensor(points, device=cuda)
    msk = torch.as_tensor(pmask, device=cuda)
    got = det.detect(pts, msk)
    trainer.model.eval_mode()
    with torch.inference_mode():
        want = trainer.model.predict(trainer.model.forward(
            det.voxelize(pts, msk)))
    assert int(got['num'].sum()) > 0
    assert torch.equal(got['num'], want['num'])
    assert (got['boxes'] - want['boxes']).abs().max().item() <= 1e-5
    before = rotated_overlap.LAUNCHES
    rc = detector3d.batch_recall(got['boxes'], got['valid'],
                                 torch.as_tensor(gt, device=cuda), (0.5, 0.7))
    assert rotated_overlap.LAUNCHES == before + 1
    assert int(rc['gt']) > 0


_CLI_SETS = ['DATA_CONFIG.VOXEL_GENERATOR.VOXEL_SIZE', '[0.32,0.32,4]',
             'DATA_CONFIG.TRAIN.MAX_NUMBER_OF_VOXELS', '4000',
             'DATA_CONFIG.TEST.MAX_NUMBER_OF_VOXELS', '4000']


@pytest.fixture
def kitti_tree(tmp_path):
    """chip_smoke.py's KITTI-format tree (4 train, 2 val ring scans; the PNG
    written without PIL) after create_data."""
    import chip_smoke
    from pcdet_tpu_torch import detect
    from pcdet_tpu_torch.tools import create_data
    root = str(tmp_path / 'kitti')
    chip_smoke.write_kitti_tree(root, 4, 2)
    create_data.main(['kitti', '--cfg_file', str(detect.DEFAULT_CFG),
                      '--data_path', root, '--workers', '2'])
    return root, chip_smoke.cli_sets(root, str(tmp_path / 'out')) + _CLI_SETS


def test_cli_round_trip_on_card(cuda, kitti_tree):
    """The train CLI (pointpillar.yaml at a 216 x 248 grid, B2, 1 epoch) and
    the test CLI on its checkpoint: recall through kernel A on the card."""
    from pcdet_tpu_torch import detect
    from pcdet_tpu_torch.tools import test, train
    _, sets = kitti_tree
    cfg = str(detect.DEFAULT_CFG)
    out = train.main(['--cfg_file', cfg, '--batch_size', '2', '--epochs', '1',
                      '--workers', '2', '--ckpt_save_interval', '1',
                      '--log_interval', '1', '--set'] + sets)
    assert out['trainer'].device.type == 'cuda'
    ckpt = str(out['ckpt_dir'] / 'checkpoint_epoch_1.pth')
    before = rotated_overlap.LAUNCHES
    res = test.main(['--cfg_file', cfg, '--batch_size', '2', '--workers', '2',
                     '--ckpt', ckpt, '--set'] + sets
                    + ['MODEL.TEST.SCORE_THRESH', '0.0'])
    assert rotated_overlap.LAUNCHES > before
    result = res['results'][1][1]
    assert result['recall/gt'] > 0
    assert all(np.isfinite(float(v)) for v in result.values())


@pytest.mark.parametrize('workers', [0, 2])
def test_loader_batches_after_cuda_is_up(cuda, kitti_tree, workers):
    """With CUDA up in this process, the forked workers give the thread
    workers' batches bit for bit."""
    import chip_smoke
    from pcdet_tpu_torch import detect
    from pcdet_tpu_torch.models.anchors import AnchorHeadTargets
    from pcdet_tpu_torch.ops.voxelizer import grid_size
    from pcdet_tpu_torch.tools import train
    torch.zeros(1, device=cuda)
    _, cfg = train.parse_config(['--cfg_file', str(detect.DEFAULT_CFG),
                                 '--set'] + kitti_tree[1])
    targets = AnchorHeadTargets(
        cfg.MODEL.RPN.RPN_HEAD.TARGET_CONFIG, np.asarray(grid_size(
            cfg.DATA_CONFIG.VOXEL_GENERATOR.VOXEL_SIZE,
            cfg.DATA_CONFIG.POINT_CLOUD_RANGE)), list(cfg.CLASS_NAMES))
    want = chip_smoke.first_epoch(cfg, targets, 2, 'thread')
    got = chip_smoke.first_epoch(cfg, targets, workers, 'process')
    assert len(got) == 2 and chip_smoke.batches_equal(got, want)


@pytest.mark.parametrize('caps', [(768, 512, 384, 256), (300, 120, 60, 40)])
def test_device_books_on_card_equal_host_books(cuda, caps):
    """`host_books.build_books_device` on the card, under torch.cuda's sync
    debug mode 'error' (a host sync raises), against the host books
    uploaded and decoded: every tensor equal; small caps drop outputs."""
    rng = np.random.RandomState(0)
    shape = (9, 40, 40)
    coords = _sorted_coords(rng, (700, 600), 700, shape)
    spec = host_books.encoder_spec(shape, caps, (1, 0, 0))
    want = host_books.upload_books(host_books.build_books_batch(
        coords, coords[..., 0] >= 0, shape, spec), spec, 700, cuda)
    c = torch.as_tensor(coords, device=cuda)
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = host_books.build_books_device(c, c[..., 0] >= 0, shape, spec)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sorted(got) == sorted(want)
    for key, book in want.items():
        pairs = (zip(book, got[key]) if isinstance(book, tuple)
                 else [(book, got[key])])
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b), key
    assert caps[0] > 300 or int(got['spconv2'][3].sum()) > 0


def test_bottleneck_and_maxpool_on_card_match_cpu(cuda, no_tf32):
    """SparseBottleneck(16, 16) (16 -> 16 -> 16 -> 64 and the 16 -> 64
    projection: 4 launches of kernel B's instances) and sparse_maxpool3d
    on device-built books against the same modules on the CPU: 1e-5 of max
    |out| (B sums in its own order), the pool's output set equal."""
    from pcdet_tpu_torch.models.backbones3d import SparseBottleneck
    from pcdet_tpu_torch.models.layers import init_weights
    rng = np.random.RandomState(1)
    shape = (9, 40, 40)
    coords = torch.as_tensor(_sorted_coords(rng, (700, 500), 700, shape))
    mask = coords[..., 0] >= 0
    feats = torch.as_tensor(rng.randn(2, 700, 16).astype(np.float32))
    level = sparse.from_voxelizer(feats * mask[..., None], coords, mask,
                                  shape)
    net = SparseBottleneck(16, 16)
    init_weights(net, torch.Generator().manual_seed(0))
    card = SparseBottleneck(16, 16).to(cuda)
    card.load_state_dict(net.state_dict())
    on_card = sparse.SparseLevel(*(t.to(cuda) for t in level[:4]), shape)
    before = gather_gemm.LAUNCHES['gather_gemm_f32']
    with torch.no_grad():
        got = card(on_card).features.cpu()
        want = net(level).features
    assert gather_gemm.LAUNCHES['gather_gemm_f32'] - before == 4
    scale = float(want.abs().max())
    assert scale > 0 and float((got - want).abs().max()) <= 1e-5 * scale
    pooled = sparse.sparse_maxpool3d(on_card, 3, 2, 1, 300)
    ref = sparse.sparse_maxpool3d(level, 3, 2, 1, 300)
    for a, b in zip(pooled[:4], ref[:4]):
        assert torch.equal(a.cpu(), b)
    assert int(ref.overflow.sum()) > 0


# --------------------------------------------------------- two cards ---

@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA devices: the check is of a second card')
    return torch.device('cuda', 0), torch.device('cuda', 1)


def test_every_kernel_on_a_second_card_equals_the_first(two_cards, no_tf32):
    """chip_smoke.py M4 (a) on a smaller book: every kernel (A, A', A'', B,
    C, D, D', D'', E and E' in f32 and bf16, the selector kernel) with its
    operands on cuda:1, launched from a new thread whose current device is
    cuda:0, bitwise equal to the same launch on cuda:0 and within its plain
    version's tolerance on cuda:1; each launch counted; the thread's
    current device left at 0 and nothing allocated on cuda:0."""
    import chip_smoke
    first, second = two_cards
    inputs = chip_smoke.card_kernel_inputs(seed=3,
                                           book=(2, 3000, 2000, 9, 32, 32))
    want = chip_smoke.card_kernel_outputs(first, inputs)
    got, launches, current, peak = chip_smoke.kernels_on_second_card(inputs)
    plain = chip_smoke.card_kernel_outputs(second, inputs, plain=True)
    for name, (counter, tol) in chip_smoke.CARD_KERNELS.items():
        assert chip_smoke.outputs_equal(got[name], want[name]), name
        assert launches.get(counter, 0) > 0, (name, launches)
        if tol == 0:
            assert chip_smoke.outputs_equal(got[name], plain[name]), name
        else:
            scale = float(plain[name].abs().max())
            assert scale > 0, name
            assert float((got[name] - plain[name]).abs().max()) \
                <= tol * scale, name
    assert current == (0, 0) and peak == 0


def test_kernel_a2_asks_every_card_for_its_carveout(two_cards):
    """Kernel A''s shared-memory carve-out is a function attribute of each
    device: a process that first asks cuda:0 and then cuda:1 finds on
    cuda:1 the blocks an SM that a process asking cuda:1 alone finds, and
    as many as on cuda:0."""
    import subprocess
    import sys
    from pathlib import Path
    head = ('import torch; from pcdet_tpu_torch.ops import rotated_overlap '
            'as ro; ')
    runs = {'both': head + ('a = ro.sorted_blocks_per_sm(); '
                            'torch.cuda.set_device(1); '
                            'print(a, ro.sorted_blocks_per_sm())'),
            'second': head + ('torch.cuda.set_device(1); '
                              'print(ro.sorted_blocks_per_sm())')}
    out = {}
    for name, code in runs.items():
        proc = subprocess.run([sys.executable, '-c', code],
                              cwd=Path(__file__).resolve().parent.parent,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        out[name] = [int(x) for x in proc.stdout.split()]
    (first, second), (alone,) = out['both'], out['second']
    assert first == second == alone, out


@pytest.mark.parametrize('mode', ['per_rank', 'sync'])
def test_two_nccl_ranks_on_two_cards_match_one_process(two_cards,
                                                       no_tf32_conv,
                                                       tmp_path, mode):
    """The two-gloo-rank test above over NCCL, one rank on each card."""
    _ranks_match_one_process(tmp_path, mode, 'cuda:0', list(two_cards),
                             'nccl')


def test_synced_bn_over_nccl_makes_no_host_sync(two_cards, tmp_path):
    """`BatchNorm` synced over two NCCL ranks, one on each card, in f64,
    its forward and backward under torch.cuda's sync debug mode 'error'
    (a host sync raises): the output, the input's gradient, the summed
    parameter gradients and both ranks' running statistics within 1e-12
    of max of one process's on the whole batch on the CPU, with and
    without a mask, channels-last and NCHW."""
    import ddp_ranks
    from pcdet_tpu_torch.models.layers import BatchNorm
    rng = np.random.RandomState(0)
    cases = []
    for shape, masked, channel_dim in (((4, 7, 5, 6), True, -1),
                                       ((4, 9, 6), True, -1),
                                       ((4, 6, 5, 5), False, 1),
                                       ((6, 8), False, -1)):
        c = shape[channel_dim]
        case = {'x': rng.randn(*shape) * 2 + 1, 'cot': rng.randn(*shape),
                'scale': rng.uniform(0.5, 1.5, c), 'bias': rng.randn(c) * 0.1,
                'channel_dim': channel_dim, 'card': True}
        if masked:
            case['mask'] = rng.rand(*shape[:-1]) > 0.3
        cases.append(case)
    ranks = ddp_ranks.run_ranks(tmp_path, ddp_ranks.bn_rank, cases,
                                device=list(two_cards), backend='nccl')
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
        pairs = [(torch.cat([g['y'] for g in got]), y.detach()),
                 (torch.cat([g['dx'] for g in got]), dx),
                 (sum(g['dw'] for g in got), dw),
                 (sum(g['db'] for g in got), db)]
        pairs += [(g[k], v) for g in got for k, v in (
            ('mean', bn.running_mean), ('var', bn.running_var))]
        for a, b in pairs:
            assert ddp_ranks.max_rel_err(a, b) <= 1e-12


def test_test_cli_on_a_second_card_equals_the_first(two_cards, kitti_tree):
    """The test CLI at `--device cuda:1` on a checkpoint of the train CLI
    (pointpillar.yaml at a 216 x 248 grid, B2, 1 epoch): kernel A launches,
    the detections of result.pkl and the logged AP string equal to those
    of `--device cuda:0` on the same checkpoint, bit for bit, and nothing
    allocated on cuda:0 while cuda:1 ran."""
    import os
    import pickle
    import chip_smoke
    from pcdet_tpu_torch import detect
    from pcdet_tpu_torch.tools import test, train
    first, second = two_cards
    _, sets = kitti_tree
    cfg = str(detect.DEFAULT_CFG)
    out = train.main(['--cfg_file', cfg, '--batch_size', '2', '--epochs', '1',
                      '--workers', '2', '--ckpt_save_interval', '1',
                      '--log_interval', '1', '--set'] + sets)
    ckpt = str(out['ckpt_dir'] / 'checkpoint_epoch_1.pth')
    runs = {}
    for dev in (second, first):
        torch.cuda.synchronize(first)
        torch.cuda.reset_peak_memory_stats(first)
        held = torch.cuda.memory_allocated(first)
        before = rotated_overlap.LAUNCHES
        res = test.main(['--cfg_file', cfg, '--batch_size', '2', '--workers',
                         '2', '--device', str(dev), '--extra_tag',
                         'card%d' % dev.index, '--ckpt', ckpt, '--set']
                        + sets + ['MODEL.TEST.SCORE_THRESH', '0.0'])
        torch.cuda.synchronize(dev)
        eval_dir, result = res['results'][1]
        with open(os.path.join(str(eval_dir), 'result.pkl'), 'rb') as f:
            annos = pickle.load(f)
        runs[dev.index] = {
            'launches': rotated_overlap.LAUNCHES - before, 'annos': annos,
            'ap': chip_smoke.logged_result(res['log_file']),
            'result': result,
            'peak': torch.cuda.max_memory_allocated(first) - held}
    got, want = runs[1], runs[0]
    assert got['launches'] > 0 and got['launches'] == want['launches']
    assert got['peak'] == 0
    assert got['ap'] == want['ap']
    assert sorted(got['result']) == sorted(want['result'])
    for k, v in want['result'].items():
        if k != 'sec_per_example':
            assert got['result'][k] == v, k
    assert len(got['annos']) == len(want['annos']) > 0
    for a, b in zip(got['annos'], want['annos']):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_trace_records_the_card(cuda, tmp_path):
    """`utils.profiler.trace` on the card: its Chrome trace holds kernel A's
    kernel beside the host's ops."""
    import json
    from pcdet_tpu_torch.utils import profiler
    rng = np.random.RandomState(0)
    corners = rotated_iou.boxes5_to_corners(torch.as_tensor(
        _boxes5(rng, (1, 512)), device=cuda)).contiguous()
    with profiler.trace(str(tmp_path)):
        rotated_overlap.pair_overlap_batched(corners[:, :64].contiguous(),
                                             corners)
        torch.cuda.synchronize()
    files = list(tmp_path.glob('*.pt.trace.json'))
    assert len(files) == 1
    events = json.loads(files[0].read_text())['traceEvents']
    kernels = [e['name'] for e in events if e.get('cat') == 'kernel']
    assert any('rotated_overlap' in k for k in kernels), kernels[:20]
