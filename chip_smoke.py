"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: PointPillar and
SECOND detect, SECOND training, the sparse convs' load strategies, the
evaluation (recall and KITTI AP) of both models, and PointPillar training
through the epoch loop to a checkpoint and its evaluation.

    python3 chip_smoke.py

Drives `pcdet_tpu_torch`'s main paths, raw scan to boxes, at the full width
of the shipped configs with random weights from a seed: PointPillar
(`tools/cfgs/pointpillar.yaml`: batch 2, 65536 points per scan, 40000
voxels, a 432 x 496 x 64 canvas, 321,408 anchors, NMS 4096 -> 500), then
SECOND (`tools/cfgs/second.yaml`: sparse shape 41 x 1600 x 1408, 25088
voxels, level caps 43520 / 29184 / 12288 / 10240, BEV 200 x 176 x 256,
211,200 anchors, NMS 4096 -> 500).  Phases, each fatal on failure:

  1. build every kernel from csrc/ with nvcc (sm_90a), and the host
     rulebook builder (csrc/host_books_native.cpp) with g++, all at once;
     registers and spills per kernel instance of the window kernels and of
     kernels A and A'' (which may not spill), A'''s blocks per SM;
  2. kernel A vs its plain PyTorch version on the card, bitwise, at the NMS
     shape (G=2, M=64, N=4096), on crafted boxes and on the NMS shape with
     degenerate quads (one-point rows, zero-length sides), its count of
     pairs kept (not culled) equal to the plain cull predicate's; its device time
     (queued behind a spin kernel), the time of a call with its launch, the
     plain version's and the bound;
  3. full-width detect at B2 through the kernel (launch count > 0, num > 0);
  4. NMS indices with the kernel == with the plain version, same candidates,
     and the share of pairs kernel A kept in each NMS round (its count,
     equal to the plain predicate's);
  5. the whole detect at B1 in f32: GPU vs CPU (counts equal, boxes 1e-3);
  6. timings: detect frames/s at B2 and B8, the voxelize / model / predict
     split (predict as top-k + decode and NMS), the NMS round count, a
     torch.profiler breakdown by kernel and by op; the kernel beside the
     plain version comes from phase 2.
  S2. gather-GEMM kernels B (f32, FFMA) and C (bf16, tensor cores) vs their
      plain versions on rules of the real B2 books at conv2_1 (K=27, 32 ->
      32) and conv_out (K=3, 64 -> 128), with all-miss rows, n_live 0 and
      n_live mid-tile (bound 1e-5 * max |plain|), two launches bitwise
      equal, their device times, the share of (tile, tap) pairs they skip,
      and at conv2_1 cuBLAS on the pre-gathered rows (`gemm_only_ms`, the
      math without the gather: a yardstick, not the same function);
  S3. shipped second.yaml detect at B2 under the default loads (launches
      of C, E or E' as the loads choose, of A one per NMS round, num > 0),
      with the voxel count, voxelizer overflow and per-level drops;
  S4. the same config in f32 at B1 through kernel B: GPU vs CPU (counts
      equal, boxes 1e-3);
  S5. timings at B2 and B8: frames/s, the voxelize / books / backbone /
      RPN / predict split, ms per sparse conv, a torch.profiler breakdown.
  T1. (built in phase 1) kernel D (csrc/gather_dw.cu) and kernel B's
      Cin=128 instances: registers and spills per instance (no dW instance
      may spill);
  T2. kernel D vs its plain version on the rules of real B2 and B8 TRAIN
      books at conv2_1 (K=27, 32 -> 32) and conv_out (K=3, 64 -> 128, D's
      shape under the default loads), n_live real, mid-sub-tile and 0, each
      book as built and with a sub-tile where no tap is found and a tap no
      row of a chunk finds (bound 1e-4 * max |plain|), two launches bitwise
      equal; kernel B's 128 -> 64 instance on conv_out's transposed book
      (bound 1e-5 * max |plain|); kernel (device) and plain times at B2;
  T3. full-width second.yaml training at B2 under the default loads (train
      caps 16000 voxels, 32000 / 25600 / 13824 / 11264 per level,
      adam_onecycle): 5 steps on one batch, every loss term finite, the 5th
      loss below the 1st, the launches per step the loads predict (rows: 12
      forward and 11 feature-gradient launches of B and 12 of D);
  T4. one train step at B1 from the same weights and batch: GPU vs CPU
      loss in f32 (1e-4 relative); the 12 sparse convs' dW through the
      kernels vs through their plain versions on the card (1e-3 of max
      |dW|), and GPU vs CPU in f64 (1e-9); GPU vs CPU in f32 and each
      against f64, printed;
  T5. timings at B2 and B8: ms per step and samples/s with the batch built
      in the step and prebuilt, the voxelize / books / targets / forward /
      backward / optimizer split, a torch.profiler breakdown with kernel B's
      and D's share and the idle share; the prebuilt step again with
      cuDNN's autotuner on.
  X1. the x-window and segment kernels E, E' (f32, bf16; csrc/
      gather_gemm_xwin.cu) and D'', D' (csrc/gather_dw_xwin.cu) vs their
      plain versions on real B2 books at conv2_1 (subm, 32 -> 32), conv3's
      strided conv (32 -> 64) and its transposed book (64 -> 32): n_live
      real, mid-tile and 0, bound 1e-5 * max |plain| (E, E') and 1e-4 (D'',
      D'), E and E' bitwise equal to kernel B (f32) or C (bf16) on the same
      book, E, E', D'' and D' bitwise repeatable, E' and D' at S = 256 and
      16 with the segment and window branches counted on the card equal to
      the descriptors' count and both > 0; D'' and D' also on the B8 book of
      conv2_1 and on selectors with a sub-tile where no tap is found and an
      x-tap no row of a chunk finds; no tap dropped by any book's
      selectors;
  X2. second.yaml detect at B2 under loads.fwd xwin and seg, bf16 and f32:
      11 launches of E / E' and 1 of C (B in f32), num > 0, num and boxes
      equal to the rows run within 1e-3 (E / E' give C's bits in bf16 and
      B's in f32);
  X3. training at B2 under loads (xwin, xwin), (seg, seg) and the default:
      5 steps, finite losses, the 5th below the 1st, the launches per step;
      one B1 step's sparse-conv dW through each equal to the rows step's
      within 1e-3 of max |dW|;
  X4. device times (queued behind a spin kernel): each kw=3 conv's kernels
      B / C, E, E' (forward f32 and bf16, feature gradient) and D, D'', D'
      at B2, with the (tile, tap) pairs B / C skip, conv_out's B and C, and
      the sums of B per train step and of C per detect batch; the selector
      builds, and per direction each loads choice's kernel sum plus the
      selector builds it adds over the default; detect frames/s and
      backbone ms at B2 and B8 under each loads.fwd; the prebuilt train
      step and its forward / backward split at B2 and B8 under each loads
      choice.
  V1. kernel A'' (csrc/rotated_overlap_sorted.cu, built in phase 1, its
      registers and spills reported there) vs its plain version at the NMS
      shape, within 6 m of the origin, on the CPU test's 12 x 140 boxes, on
      crafted boxes, on a B8 recall grid with zero-padded rows on both
      sides, on the NMS shape with degenerate quads, on the crafted quads
      of tests/test_torch_port_overlap_sorted.py (`sorted_crafted_quads`)
      with a NaN and an Inf corner (finite areas) and on finite corners
      whose products overflow (`overflow_quads`: areas of +inf and NaN):
      bitwise equal (`torch.equal`; NaN equal to NaN), two launches bitwise
      equal; on the first four A'' vs
      kernel A, the other method, within a bound that grows with the
      boxes' range (2e-5 within 6 m);
  V2. the evaluation (train.eval_loop.eval_one_epoch) of second.yaml, then
      pointpillar.yaml, at B2 on 16 SyntheticDataset scenes at bench density
      (DATA_CONFIG.SYNTHETIC): the result dict (recall, AP, overflow,
      sec_per_example), one launch of A per batch for recall, A'' beside it
      as A's cross-check, C in SECOND's convs; recall/gt > 0, all finite;
  V3. on V2's batches: (a) A'' vs A within 5e-4 m^2 over the live pairs of
      every recall grid, the recall counts through either equal, A bitwise
      equal to its plain version on every pair (zero-padded GT rows
      included); (b) the card's counts equal to the CPU's on the same
      predictions; (c) the GT as detections give recall 1.0 and AP >= 99.99
      for every class;
  V4. SECOND eval frames/s at B2 and B8 with the detect / recall /
      annotate / evaluate split (host clock, median of 3); A, A' (G = 1)
      and A'' on the B8 recall grid and at the NMS shape, kernel and plain
      ms beside the bound (A's least work for all three: the cull's
      operations on every pair, the clipping's on the pairs it keeps);
      A'''s accepted-list lengths on the B8 recall grid (mean, max) and
      its operations a pair from them (`a2_ops_per_pair`).
  P1. full-width pointpillar.yaml training at B2 (train cap 16000 voxels x
      32 points, PFN 64 on masked batch statistics, RPNV2 in f32, 321,408
      anchors, adam_onecycle): 5 steps on one batch, every loss term
      finite, the 5th loss below the 1st, overflow/voxelizer per step;
  P2. one B1 step from the same weights and batch, GPU vs CPU: the loss in
      f32 (TF32 off) to 1e-4 relative, in f64 the loss and every gradient
      to 1e-9 (of max |grad|); the largest gradient error per module
      printed for GPU f32 vs CPU f32, each vs CPU f64, and f64 vs f64;
  P3. ms per step and samples/s at B2 and B8, the batch built and
      prebuilt; the voxelize / targets / upload / forward + loss /
      backward / optimizer split, the targets' bytes; a torch.profiler list
      of the top kernels with the device's idle share;
  P4. `train.train_loop.train_model` for 2 epochs of 2 B2 batches
      (`TrainScans`, 4 scenes) into a temporary directory, one checkpoint
      an epoch; `restore_train_state` of the latest into a trainer of other
      weights equal to the live state bitwise (every parameter, buffer,
      optimizer moment, count and the step); `eval_one_epoch` at B2 on 16
      `SyntheticDataset` scenes of a detector built from the checkpoint
      (`detect.build_detector(cfg, dev, checkpoint=path)`): kernel A's
      launches (counted from 0 just before) > 0, every result finite; the
      restored detector's detections equal to the trained module's own
      eval detect (counts and valid equal, boxes within 1e-5).
  L1. a KITTI-format tree of 16 train + 8 val bench-density ring scans
      (labels in the camera frame, calib, road planes, a 1242 x 375 PNG
      written with zlib / struct), then `python -m pcdet_tpu_torch.tools.
      create_data kitti`: the infos' counts, the GT database per class;
  L2. the train CLI (`tools.train.main`, in-process) on pointpillar.yaml at
      full width, B2, 2 epochs, 4 thread workers, a checkpoint an epoch:
      every logged loss finite, the last 4 below the first 4 on average,
      `overflow/voxelizer` in every logged step; the loader's epoch 0
      bitwise equal under 4 process workers (forked with CUDA up) and 0
      workers; one step from its first batch GPU vs CPU as P2's (f32 loss
      1e-4 relative, f64 loss and every gradient 1e-9); on a second tree of
      64 train frames, ms per step and samples/s at B2 and B8 with the
      loader's prefetch (4 workers) and without (0): each epoch's first
      step (the pool's start and an empty queue) apart from the steady
      steps after it, the ms the loop waits on the loader, the device's
      idle share (torch.profiler), the upload;
  L3. the test CLI on L2's last checkpoint, 8 val frames at B2: kernel A's
      launches (from 0) > 0, recall, the official AP and the COCO strings
      finite, the logged AP string equal to the evaluator run again on the
      CLI's result.pkl; `--eval_all --max_waiting_mins 0` evaluates both
      checkpoints and lists them in eval_list_val.txt;
  L4. second.yaml through the same pair: 1 epoch of 2 B2 batches (books
      from the loader's `batch_transform`; B, D, D' launch; no tap outside
      its x-window), its checkpoint evaluated on 4 val frames (C, A).

Prints the card's name and power limit, a JSON line with the kernels (A,
B, C, D, E, E', D'', D', A', A''), each with its launches on its main path
(by path for A, B, C, D and D': the B2 detect, P4's evaluation, the CLI
pair's training and evaluation), its error
against its plain version, its time and the plain version's, and its bound
(`bound_ms`, the larger of its bytes over 3.35 TB/s and its operations over
the peak rate of their type, 67 TFLOP/s for f32 outside the tensor cores
and 989 TFLOP/s for bf16, the H100 SXM's published dense rates, for this
run's inputs),
and as its last line {"ok": true, "device": {...}}.  Exits nonzero, with no
result line, when no CUDA device is present or any phase fails.
"""
import concurrent.futures
import copy
import itertools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch


# the H100 SXM's published peaks (NVIDIA data sheet, dense): HBM bytes per
# second; operations per second by the operands' type, f32 outside the tensor
# cores and bf16 (f32 sums) on them
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# kernel A's operations per (A box, B box) pair it clips: about 460 flops
# and 32 divisions (csrc/rotated_overlap.cu)
A_OPS_PER_PAIR = 492
# and per pair it tests, clipped or not (`maybe_nonzero`: 4 adds, 4
# compares, 3 ors)
CULL_OPS_PER_PAIR = 11
# the closed form of a kept pair whose B is one finite point
# (`point_b_area`: 2 subtractions, 2 multiplications, 2 additions an edge,
# then + 0 and a max); one whose A is one finite point is +0.0, no operation
POINT_B_OPS_PER_PAIR = 26
# kernel A''s, counted from csrc/rotated_overlap_sorted.cu the same way
# (each arithmetic op, compare and select one), as `a2_ops_per_pair` adds
# them up from the work its data reaches: on every pair the 8 inside tests
# (8 x 32, counted whole), the 8 edge vectors (16) and the 16 crossings'
# denominators and their tests (16 x 5)
A2_FIXED_OPS = 352
# the evaluation's scenes: DATA_CONFIG.SYNTHETIC at bench density
EVAL_SYNTHETIC = {'NUM_SAMPLES': 16, 'NUM_OBJECTS': 24, 'GROUND_MODE': 'rings',
                  'PTS_PER_OBJ': 400, 'RING_KEEP': 0.35}


def a2_ops_per_pair(work):
    """Kernel A''s operations on each pair, from its
    `rotated_overlap.sorted_work_plain` counts: A2_FIXED_OPS, then 8 for
    each crossing past its denominator (its t and t's tests), 6 for each
    past t too (u and its tests), 4 for each valid one (its point) and 6
    for each dedup test (counted whole); with a list of L >= 3 entries,
    the centroid 2 L + 4, the angles 13 L, the shoelace 5 L and the
    successor scan 8 per (i, j != i)."""
    n = work['length']
    return (A2_FIXED_OPS + 8 * work['denom_ok'] + 6 * work['t_ok']
            + 4 * work['crossings'] + 6 * work['dedup_tests']
            + (n >= 3) * (4 + 20 * n + 8 * n * (n - 1)))


def require(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


def bound_ms(ops, nbytes, dtype=torch.float32):
    """(least ms the card could take, 'bytes' or 'operations'), with the
    operations at the peak rate of operands of `dtype`."""
    t_ops = 1e3 * ops / PEAK_OPS_PER_S[dtype]
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def gather_work(table, rules, n_live, cout, index_bytes_per_row, tail_bytes):
    """(operations, bytes, operand dtype) of one gather-GEMM or dW call on
    these inputs: 2 Cin Cout per found tap of a live row; the distinct table
    rows the live rows read, the index data of the live rows
    (`index_bytes_per_row`), and `tail_bytes` (weights and output, or g and
    dW), each once."""
    b, v, k = rules.shape
    n_in, cin = table.shape[1] - 1, table.shape[2]
    live = torch.arange(v, device=rules.device)[None] < n_live[:, None]
    found = (rules != n_in) & live[..., None]
    rows = sum(int(torch.unique(rules[i][found[i]]).numel())
               for i in range(b))
    ops = 2 * cin * cout * int(found.sum())
    nbytes = (rows * cin * table.element_size()
              + int(live.sum()) * index_bytes_per_row + tail_bytes)
    return ops, nbytes, table.dtype


def skipped_share(rules, n_in, n_live, tile):
    """Share of the (live tile, tap) pairs that kernels B / C skip: taps
    found (a rule in [0, n_in)) in no live row of a tile of `tile` rows."""
    b, v, k = rules.shape
    rows = torch.arange(v, device=rules.device)
    found = ((rules >= 0) & (rules < n_in)
             & (rows[None] < n_live[:, None])[..., None])
    found = torch.cat([found, found.new_zeros((b, (-v) % tile, k))], 1)
    per_tile = found.reshape(b, -1, tile, k).any(2)
    live_tiles = (torch.arange(per_tile.shape[1], device=rules.device)
                  * tile)[None] < n_live[:, None]
    pairs = int(live_tiles.sum()) * k
    return 1.0 - int(per_tile[live_tiles].sum()) / pairs if pairs else 0.0


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, work):
    """One element of the `kernels` JSON line."""
    b_ms, b_by = bound_ms(*work)
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
            'bound_by': b_by, 'library_ms': None}


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters, warmup=3):
    """Mean ms per call of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters, warmup=3):
    """(mean device ms per call of fn(), host ms to enqueue the calls): the
    calls are queued behind a spin kernel of some 25 ms, so they run back to
    back on the card and a kernel shorter than its Python launch is timed,
    not the launch (valid while the host ms stay below the spin)."""
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0)
    sync()
    return start.elapsed_time(end) / iters, host_ms


def profile_detect(det, points, mask, iters=3):
    """Device time per batch by kernel, from torch.profiler (CUPTI).

    :return: (busy ms per batch, [(ms per batch, kernel name)] by time,
        [(ms per batch, op name)]: device time by the op that launched it)
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            det.detect(points, mask)
        sync()
    kernels, ops = [], []
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        row = (e.self_device_time_total / 1e3 / iters, e.key)
        (kernels if e.device_type == DeviceType.CUDA else ops).append(row)
    return (sum(ms for ms, _ in kernels), sorted(kernels, reverse=True),
            sorted(ops, reverse=True))


def ptxas_entries(log):
    """[(kernel, template ints, registers, spill store bytes)] per compiled
    instance of a library, from `nvcc -Xptxas -v`."""
    out, cur = [], None
    for line in log['ptxas'].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            base = next((k for k in ('gather_dw_xwin_partial',
                                     'gather_gemm_xwin_kernel',
                                     'gather_dw_partial', 'sum_partials',
                                     'gather_gemm_kernel',
                                     'rotated_overlap_sorted_kernel',
                                     'rotated_overlap_kernel', 'edgeclip')
                         if k in name), name[:40])
            cur = [base, ('bf16,' if 'bfloat16' in name else '')
                   + ('seg,' if 'Lb1E' in name else '') + ','.join(
                       re.findall(r'Li(\d+)E', name)), 0, 0]
            out.append(cur)
        elif cur is not None and 'spill stores' in line:
            cur[3] = int(line.split('bytes spill stores')[0].split(',')[-1])
        elif cur is not None and 'Used' in line and 'registers' in line:
            cur[2] = int(line.split('Used')[1].split('registers')[0])
    return out


def sorted_ptxas_report():
    """ptxas's report on csrc/rotated_overlap_sorted.cu built afresh with
    the port's device flags, to a cubin beside the port's libraries."""
    from pcdet_tpu_torch.ops import cuda_build
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ('-shared', '-Xcompiler', '-fPIC')]
    out = cuda_build.BUILD_DIR / 'rotated_overlap_sorted_report.cubin'
    return subprocess.run(
        [cuda_build._nvcc(), *flags, '-cubin', '-Xptxas', '-v', '-o',
         str(out), str(cuda_build.CSRC_DIR / 'rotated_overlap_sorted.cu')],
        check=True, capture_output=True, text=True).stderr


def print_ptxas(name, log):
    """One line per library: registers and spills over its kernel
    instances."""
    rows = ptxas_entries(log)
    if not rows:
        print('[build] %s: ptxas report empty (library reused)' % name)
        return
    regs = [r[2] for r in rows]
    spills = [r[3] for r in rows]
    print('[build] %s: %d kernel instances, %d-%d registers, spill stores '
          '%d bytes at most (%d instances spill)' % (
              name, len(rows), min(regs), max(regs), max(spills),
              sum(1 for x in spills if x)))


def rand_boxes5(rng, shape, spread=30.0):
    cx = rng.uniform(-spread, spread, shape)
    cy = rng.uniform(-spread, spread, shape)
    w = rng.uniform(0.5, 5.0, shape)
    l = rng.uniform(0.5, 7.0, shape)
    ang = rng.uniform(-np.pi, np.pi, shape)
    return np.stack([cx - w / 2, cy - l / 2, cx + w / 2, cy + l / 2, ang],
                    axis=-1).astype(np.float32)


def near_boxes5(rng, n, scale=6.0):
    """n boxes with centres within `scale` m of the origin and sides 0.5-5 m
    (tests/test_torch_port_eval.py's random boxes)."""
    cx = rng.uniform(-scale, scale, n)
    cy = rng.uniform(-scale, scale, n)
    dx = rng.uniform(0.5, 5.0, n)
    dy = rng.uniform(0.5, 5.0, n)
    ang = rng.uniform(-np.pi, np.pi, n)
    return np.stack([cx - dx / 2, cy - dy / 2, cx + dx / 2, cy + dy / 2, ang],
                    axis=-1).astype(np.float32)


def crafted_boxes5():
    """Identical, touching, contained and disjoint pairs
    (tests/test_pallas_overlap.py's cases)."""
    a = np.array([[-5, -5, 5, 5, 0.0]] * 5 + [[0, 0, 2, 4, 0.7]],
                 np.float32)
    b = np.array([[-1, -1, 1, 1, 0.9],          # contained, rotated
                  [5, -1, 7, 1, 0.0],            # shares an edge: area 0
                  [100, 100, 102, 102, 0.3],     # disjoint
                  [-5, -5, 5, 5, np.pi / 2],     # same square turned 90°
                  [-5, -5, 5, 5, 0.0],           # identical
                  [0, 0, 2, 4, 0.7]], np.float32)  # identical, rotated
    return a, b


def sorted_crafted_quads():
    """{case: (K, 4, 2) f32 numpy corners}: sets of quads whose every
    ordered pair stresses kernel A''s candidates (tests/
    test_torch_port_overlap_sorted.py holds its compacted order to the
    plain version on them): identical and turned boxes, shared edges and
    corners, collinear overlapping edges, containment, boxes at 60-68 m,
    one-point quads inside and outside a box, zero-length sides, collinear
    candidates at one pseudo-angle (a tie in the successor scan) and a box
    against itself turned by micro-radians (16 accepted candidates)."""
    from pcdet_tpu_torch.ops import rotated_iou

    def corners5(boxes):
        return rotated_iou.boxes5_to_corners(torch.as_tensor(
            np.asarray(boxes, np.float32))).numpy()

    def point(x, y):
        return np.full((4, 2), (x, y), np.float32)

    def zero_side(boxes):
        q = corners5(boxes)
        q[:, 2] = q[:, 3]                # corner 2 onto corner 3
        return q

    far = near_boxes5(np.random.RandomState(5), 6, 2.0) + np.float32(
        [64, 64, 64, 64, 0])
    return {
        'identical and turned 90 degrees': corners5(
            [[-2, -1, 2, 1, 0.3], [-2, -1, 2, 1, 0.3],
             [-2, -1, 2, 1, 0.3 + np.pi / 2], [-2, -2, 2, 2, 0.0],
             [-2, -2, 2, 2, np.pi / 2]]),
        'shared edge and shared corner': corners5(
            [[0, 0, 2, 2, 0.0], [2, 0, 4, 2, 0.0], [2, 2, 4, 4, 0.0],
             [0, 2, 2, 5, 0.0], [-1, -1, 0, 0, 0.0]]),
        'collinear overlapping edges': corners5(
            [[0, 0, 4, 2, 0.0], [1, 0, 3, 1, 0.0], [2, 0, 6, 2, 0.0],
             [0, 1, 4, 3, 0.0], [3, -1, 4, 2, 0.0], [0, 0, 4, 2, 0.0]]),
        'contained': corners5(
            [[-5, -5, 5, 5, 0.0], [-1, -1, 1, 1, 0.9],
             [-4, -0.5, 4, 0.5, 0.2], [-0.1, -0.1, 0.1, 0.1, 0.0]]),
        'boxes at 60-68 m': corners5(np.concatenate([
            [[60, 60, 64, 62, 0.4], [61, 60.5, 68, 61.5, -0.2],
             [62, 58, 66, 67, 1.1]], far])),
        'one-point quads inside and outside a box': np.concatenate([
            corners5([[0, 0, 4, 2, 0.1], [-3, -3, -1, 3, 0.0]]),
            np.stack([point(1.0, 0.5), point(3.0, 3.0), point(0, 0),
                      point(0, 0)])]),
        'quads with a zero-length side': np.concatenate([
            zero_side([[0, 0, 4, 2, 0.3], [1, -1, 3, 3, -0.4]]),
            corners5([[0, 0, 4, 2, 0.3], [1, 0, 2, 1, 0.0]])]),
        # three collinear candidates, two at one pseudo-angle from the
        # centroid: the successor scan's tie goes to the first (strict `<`)
        'collinear corners, tied angles': np.concatenate([
            np.float32([[[0, 0], [2, 0], [2, 1], [2, 3]]]),
            corners5([[2, -1, 4, 4, 0.0], [1, -1, 3, 4, 0.0]])]),
        # a 0.5 m box and itself turned by micro-radians: corners and
        # crossings inside the tolerances but over 1e-6 apart
        'turned by micro-radians, long lists': corners5(
            [[-0.25, -0.25, 0.25, 0.25, t] for t in
             (0.0, 5e-6, np.pi / 4, np.pi / 4 + 3e-6)]),
    }


def overflow_quads():
    """(5, 4, 2) f32 numpy corners, each finite, whose products overflow:
    squares of half-side 1e38 at the origin and at (2e38, 0), of 1e20 at
    the origin and of 3e19 at (1e20, 1e20), and a diamond of radius 1e20.
    Among their ordered pairs kernel A''s plain version gives areas of +inf
    and NaN."""
    def square(cx, cy, h):
        return [[cx - h, cy - h], [cx + h, cy - h], [cx + h, cy + h],
                [cx - h, cy + h]]

    return np.float32([square(0, 0, 1e38), square(2e38, 0, 1e38),
                       square(0, 0, 1e20), square(1e20, 1e20, 3e19),
                       [[0, -1e20], [1e20, 0], [0, 1e20], [-1e20, 0]]])


def degenerate_quads(ca, cb):
    """Copies of an NMS-shape grid (G, 64, 4, 2) x (G, N >= 3600, 4, 2) with
    degenerate quads: zero-padded rows (one-point quads at the origin) in
    both, one-point quads at (5, 5), and a zero-length side in each."""
    ca, cb = ca.clone(), cb.clone()
    ca[:, 50:] = 0.0
    cb[:, 3000:3500] = 0.0
    cb[:, 3500:3600] = 5.0
    ca[:, 40:45, 1] = ca[:, 40:45, 0]
    cb[:, 100:200, 2] = cb[:, 100:200, 3]
    return ca, cb


def recall_grid_boxes7(rng, g=8, m=500, n=128):
    """(g, m, 7) predictions and (g, n, 7) GT boxes of a recall grid (the
    eval's B8 shape by default): random boxes over KITTI's range, sides
    0.5-4.5 m, a live prefix in each sample (0 to m - 1 predictions, 10-39
    GT) and zero-padded rows after it, which are one-point quads in BEV."""
    def boxes7(k, live):
        out = np.zeros((g, k, 7), np.float32)
        for i, count in enumerate(live):
            out[i, :count] = np.concatenate([
                rng.uniform([0, -40, -2], [70.4, 40, 0], (count, 3)),
                rng.uniform(0.5, 4.5, (count, 3)),
                rng.uniform(-np.pi, np.pi, (count, 1))], -1)
        return out

    return boxes7(m, rng.randint(0, m, g)), boxes7(n, rng.randint(10, 40, g))


def place_beside(qa, qb, gap, axis, side, across):
    """Move each quad of `qb` (P, 4, 2) beside its `qa` quad so that their
    axis-aligned boxes lie `gap` apart on `axis` (0 x, 1 y; B above A's
    high side when `side` is 1, below its low side when 0) and overlap
    along the other axis, at the fraction `across` of the overlapping
    range.  -> (qa, moved qb), both f32 numpy."""
    qa = np.asarray(qa, np.float32)
    qb = np.asarray(qb, np.float32).astype(np.float64)
    lo_a, hi_a = qa.min(1), qa.max(1)
    lo_b, hi_b = qb.min(1), qb.max(1)
    rows = np.arange(len(qa))
    other = 1 - axis
    shift = np.zeros((len(qa), 2))
    shift[rows, axis] = np.where(
        side == 1, hi_a[rows, axis] + gap - lo_b[rows, axis],
        lo_a[rows, axis] - gap - hi_b[rows, axis])
    lo = lo_a[rows, other] - hi_b[rows, other]
    shift[rows, other] = lo + across * (hi_a[rows, other] - lo_b[rows, other]
                                        - lo)
    return qa, (qb + shift[:, None]).astype(np.float32)


def near_miss_pairs(rng, m=64, n=4096, spread=70.0):
    """(1, m, 4, 2) x (1, n, 4, 2) f32 corners, numpy: column j placed
    beside row j % m, their axis-aligned boxes 1-3 of kernel A's cull gaps
    apart (3 in 4, most just past one gap) or inside one gap, on x or y,
    either side; the columns' sides 1 mm to 7 m (slivers)."""
    from pcdet_tpu_torch.ops import rotated_iou
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    a = rotated_iou.boxes5_to_corners(torch.as_tensor(
        rand_boxes5(rng, m, spread))).numpy()
    w = np.exp(rng.uniform(np.log(1e-3), np.log(7.0), (2, n)))
    b = rotated_iou.boxes5_to_corners(torch.as_tensor(np.stack(
        [-w[0] / 2, -w[1] / 2, w[0] / 2, w[1] / 2,
         rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32))).numpy()
    gap = ro.CULL_GAP * np.where(rng.rand(n) < 0.75,
                                 1 + np.exp(rng.uniform(-9, 0.7, n)),
                                 rng.rand(n))
    _, b = place_beside(a[np.arange(n) % m], b, gap, rng.randint(0, 2, n),
                        rng.randint(0, 2, n), rng.rand(n))
    return a[None], b[None]


def candidates(model, ret, tc):
    """predict's class-agnostic masked top-k and decode, before NMS."""
    from pcdet_tpu_torch.models import detector3d
    b, a = ret['cls_preds'].shape[0], model.anchors.shape[0]
    return detector3d.topk_decode(
        ret['cls_preds'].reshape(b, a, -1).amax(-1),
        ret['box_preds'].reshape(b, a, -1),
        ret['dir_cls_preds'].reshape(b, a, -1), model.anchors,
        model.box_coder, model.head_args, float(tc.SCORE_THRESH),
        int(tc.NMS_PRE_MAXSIZE_LAST))


def run_nms(cand, tc, overlap_fn=None):
    """predict's NMS on `candidates`, through kernel A unless `overlap_fn`."""
    from pcdet_tpu_torch.ops import nms
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    return nms.nms_bev_batched(
        cand['boxes5'], cand['rank'], float(tc.NMS_THRESH),
        pre_max=int(tc.NMS_PRE_MAXSIZE_LAST),
        post_max=int(tc.NMS_POST_MAXSIZE_LAST), valid_mask=cand['valid'],
        overlap_fn=overlap_fn or ro.pair_overlap_batched)


def second_detector(cfg, dev, loads=None):
    """SECOND with random weights from seed 0 and conv_cls's bias zeroed:
    the focal prior puts every score near 0.01, under SCORE_THRESH 0.3."""
    from pcdet_tpu_torch import detect as detect_mod
    det = detect_mod.build_detector(cfg, dev, seed=0, loads=loads)
    with torch.no_grad():
        det.model.module.rpn_head.conv_cls.bias.zero_()
    return det


def voxel_overflow(det, points, mask):
    """Occupied in-range voxels beyond the cap, per sample (the JAX loader's
    `voxel_overflow`)."""
    vs = torch.tensor(det.voxel_size, device=points.device)
    lo = torch.tensor(det.pc_range[:3], device=points.device)
    hi = torch.tensor(det.pc_range[3:], device=points.device)
    out = []
    for i in range(points.shape[0]):
        p = points[i, mask[i], :3]
        p = p[((p >= lo) & (p < hi)).all(-1)]
        cells = torch.unique(torch.floor((p - lo) / vs).long(), dim=0)
        out.append(max(cells.shape[0] - det.max_voxels, 0))
    return out


def device_ms(fn, iters):
    """Mean device ms per call of fn(), queued behind a spin kernel (a short
    kernel is timed, not its Python launch)."""
    return queued_ms(fn, iters)[0]


def gemm_yardstick(table, rules, w, live):
    """ms of cuBLAS's (sum of live rows, K Cin) @ (K Cin, Cout) on the
    pre-gathered rows of every tap, in the operands' dtype: the math of a
    gather-GEMM without its gather (not the same function)."""
    k, cin, cout = w.shape
    gathered = torch.cat([table[i, rules[i, :int(n)].long()].reshape(-1, k * cin)
                          for i, n in enumerate(live.tolist())])
    flat = w.reshape(k * cin, cout)
    return device_ms(lambda: torch.matmul(gathered, flat), 20)


def gather_gemm_vs_plain(dev, det, books):
    """S2: kernels B and C against their plain versions on the card, on
    the rules of real books at conv2_1 and conv_out; two launches bitwise
    equal; device times, the share of (tile, tap) pairs skipped and, at
    conv2_1, cuBLAS on the pre-gathered rows as a yardstick.

    :return: {'f32'|'bf16': {'err': max abs error, 'rel': error / max
        |plain|, 'ms': kernel ms, 'plain_ms': plain ms}} at conv2_1
    """
    from pcdet_tpu_torch.ops import gather_gemm as gg
    spec = {op[1]: op for op in det.model.host_book_spec(det.max_voxels)}
    cases = (   # name, rules, input mask, output mask, n_in, Cin, Cout
        ('conv2_1', books['subm2'], books['spconv2'][2], books['spconv2'][2],
         int(spec['spconv2'][5]), 32, 32),
        ('conv_out', books['convout'][4], books['spconv4'][2],
         books['convout'][2], int(spec['spconv4'][5]), 64, 128))
    gen = torch.Generator(device='cpu').manual_seed(1)
    stats = {}
    for name, rules, in_mask, out_mask, n_in, cin, cout in cases:
        b, v_out, k = rules.shape
        feats = torch.randn((b, n_in + 1, cin), generator=gen).to(dev)
        feats[:, :n_in] *= in_mask[..., None]
        feats[:, n_in] = 0
        w32 = (torch.rand((k, cin, cout), generator=gen) * 2 - 1).to(dev)
        w32 /= (cin * k) ** 0.5
        live = out_mask.sum(1, dtype=torch.int32)
        mid = torch.minimum(live, torch.full_like(live, 64 * 37 + 21))
        all_miss = (rules == n_in).all(-1)
        require(bool(all_miss.any()), name + ': no all-miss row to check')
        for dtype, tag in ((torch.float32, 'f32'), (torch.bfloat16, 'bf16')):
            table, w = feats.to(dtype), w32.to(dtype)
            errs, scale = [], 0.0
            for n_live in (live, mid, torch.zeros_like(live)):
                got = gg.gather_gemm(table, rules, w, n_live)
                again = gg.gather_gemm(table, rules, w, n_live)
                want = gg.gather_gemm_plain(table, rules, w, n_live)
                sync()
                require(torch.equal(got, again), '%s %s: two launches differ'
                        % (name, tag))
                errs.append((got - want).abs().max().item())
                scale = max(scale, want.abs().max().item())
                require(not bool(got[all_miss].any()),
                        '%s %s: an all-miss row is not zero' % (name, tag))
                rows = torch.arange(v_out, device=dev)[None]
                require(not bool(got[rows >= n_live[:, None]].any()),
                        '%s %s: a row past n_live is not zero' % (name, tag))
            err = max(errs)
            require(err <= 1e-5 * scale, '%s %s: kernel vs plain %g > 1e-5 '
                    '* %g' % (name, tag, err, scale))
            ms = device_ms(lambda: gg.gather_gemm(table, rules, w, live), 20)
            plain_ms = cuda_ms(
                lambda: gg.gather_gemm_plain(table, rules, w, live), 3, 1)
            tile = gg.tile_rows(dtype, cin, cout)
            print('[second S2] %s %s (B=%d, V_out=%d, K=%d, %d -> %d, live %s):'
                  ' max |kernel - plain| %.3g (%.3g of max |plain| %.4g; '
                  'real, mid-tile %s and zero n_live); two launches bitwise '
                  'equal; kernel %.4f ms (device), plain %.4f ms; %d-row '
                  'tiles, (tile, tap) pairs skipped %.1f%%' % (
                      name, tag, b, v_out, k, cin, cout, live.tolist(), err,
                      err / scale, scale, mid.tolist(), ms, plain_ms, tile,
                      100 * skipped_share(rules, n_in, live, tile)))
            if name == 'conv2_1':
                gemm_ms = gemm_yardstick(table, rules, w, live)
                print('[second S2] conv2_1 %s yardstick gemm_only_ms %.4f: '
                      'cuBLAS on the pre-gathered rows of all 27 taps, the '
                      'math without the gather (not the same function; '
                      'kernel %.4f ms)' % (tag, gemm_ms, ms))
                stats[tag] = {'err': err, 'rel': err / scale, 'ms': ms,
                              'plain_ms': plain_ms, 'work': gather_work(
                                  table, rules, live, cout, 4 * k,
                                  w.numel() * w.element_size()
                                  + 4 * b * v_out * cout)}
    return stats


def second_detect_checks(preds, post, batch):
    num = preds['num'].tolist()
    require(all(x > 0 for x in num), 'SECOND: no detections: %s' % num)
    require(tuple(preds['boxes'].shape) == (batch, post, 7), 'boxes shape')
    require(bool(torch.isfinite(preds['boxes']).all())
            and bool(torch.isfinite(preds['scores']).all()), 'non-finite')
    for i in range(batch):
        k = num[i]
        require(bool(preds['valid'][i, :k].all())
                and not bool(preds['valid'][i, k:].any()), 'valid prefix')
        labels = preds['labels'][i, :k]
        require(bool(((labels >= 1) & (labels <= 3)).all()), 'labels')
        require(bool((preds['boxes'][i, :k, 3:6] > 0).all()), 'box sizes')
    return num


def conv_ms(det, vox, books, iters=3):
    """ms per sparse conv block (conv, BN, ReLU, mask) by CUDA events around
    each of the 12 SpConvBNReLU modules of one backbone run."""
    from pcdet_tpu_torch.models.backbones3d import SpConvBNReLU
    module = det.model.module
    blocks = [(n, m) for n, m in module.rpn_net.named_modules()
              if isinstance(m, SpConvBNReLU)]
    events = {n: [] for n, _ in blocks}
    hooks = []
    for n, m in blocks:
        def pre(_, __, n=n):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[n].append([e])

        def post(_, __, ___, n=n):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[n][-1].append(e)
        hooks += [m.register_forward_pre_hook(pre),
                  m.register_forward_hook(post)]
    try:
        with torch.inference_mode():
            for _ in range(iters):
                module(vox['voxels'], vox['num_points_per_voxel'],
                       vox['coordinates'], vox['voxel_mask'], books)
        sync()
    finally:
        for h in hooks:
            h.remove()
    return [(n, sum(a.elapsed_time(b) for a, b in events[n]) / iters)
            for n, _ in blocks]


def forward_launches(loads, dtype, steps=1, train=False):
    """The sparse-conv launches a SECOND batch (or `steps` train steps)
    makes under `loads`: {LAUNCHES key: count}.  Of the 12 convs, the 11
    kw=3 ones take loads.fwd's kernel (E, E' or B / C) and conv_out B / C;
    in training 11 feature gradients (not conv_input's) and 12 dW; window
    loads build the books' selectors once per batch or step."""
    t = 'bf16' if dtype == torch.bfloat16 else 'f32'
    name = {'rows': 'gather_gemm', 'xwin': 'gather_gemm_xwin',
            'seg': 'gather_gemm_seg'}[loads.fwd]
    out = {}

    def add(key, n):
        out[key] = out.get(key, 0) + n * steps
    add('gather_gemm_' + t, 1)
    add('%s_%s' % (name, t), 11)
    if loads.fwd != 'rows' or (train and loads.dw != 'rows'):
        # selectors of the 7 kw=3 books, and in training under window
        # forward loads of the 3 transposed strided books
        add('xwin_selectors', 7 + (3 if train and loads.fwd != 'rows' else 0))
    if train:
        add('gather_gemm_%s_dgrad' % t, 1)
        add('%s_%s_dgrad' % (name, t), 10)
        dw = {'rows': 'gather_dw', 'xwin': 'gather_dw_xwin',
              'seg': 'gather_dw_seg'}[loads.dw]
        add('gather_dw', 1)
        add(dw, 11)
    return out


def all_launches():
    """Every launch counter of the sparse-conv kernels, by key."""
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import gather_xwin as gx
    return {**gg.LAUNCHES, **gx.LAUNCHES, **gd.LAUNCHES}


def reset_launches():
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import gather_xwin as gx
    for counts in (gg.LAUNCHES, gx.LAUNCHES, gd.LAUNCHES):
        for k in counts:
            counts[k] = 0
    gx.reset_seg_tiles()


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def run_second(dev, cfg, batches=(2, 8)):
    """Phases S1-S5 on SECOND; returns the kernels' JSON entries."""
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.ops import cuda_build, host_books, sparse
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    tc = cfg.MODEL.TEST
    post = int(tc.NMS_POST_MAXSIZE_LAST)

    # S1. build (started with the others in phase 1) ----------------------
    gg.build()
    log = cuda_build.BUILD_LOG['gather_gemm']
    print('[second S1] gather_gemm.cu: %.2f s (cached=%s)'
          % (log['seconds'], log['cached']))
    print_ptxas('gather_gemm.cu', log)
    print('[second S1] per instance (B: Cin, Cout, rows, stages, rows x '
          'columns a thread; C: Cin, Cout, rows): %s' % ('; '.join(
              '%s<%s> %d regs, %d B spilled' % tuple(r)
              for r in ptxas_entries(log)) or 'ptxas report empty'))

    det = second_detector(cfg, dev)
    pts_np, mask_np = detect_mod.make_scans(cfg, max(batches), ring_keep=0.35)
    pts_all = torch.as_tensor(pts_np, device=dev)
    mask_all = torch.as_tensor(mask_np, device=dev)
    pts2, mask2 = pts_all[:2].contiguous(), mask_all[:2].contiguous()

    # S2. kernels vs plain on real B2 books --------------------------------
    with torch.inference_mode():
        vox = det.voxelize(pts2, mask2)
        books = det.books(vox)
    kstats = gather_gemm_vs_plain(dev, det, books)

    # S3. shipped config (bf16 sparse stack) at B2 under the default loads -
    det.detect(pts2, mask2)                          # warm-up
    sync()
    reset_launches()
    ro.LAUNCHES = 0
    preds = det.detect(pts2, mask2)
    sync()
    counts = nonzero(all_launches())
    launches_a = ro.LAUNCHES
    launches_c = counts.get('gather_gemm_bf16', 0)
    num = second_detect_checks(preds, post, 2)
    with torch.inference_mode():
        ret = det.model.forward(dict(vox, books=books))
    drops = {k: v.tolist() for k, v in ret['overflow'].items()}
    expect = forward_launches(det.loads, det.model.module.compute_dtype)
    print('[second S3] detect B2 (second.yaml, bf16 sparse stack, loads %s): '
          'num %s; launches %s (12 convs per batch), kernel A %d (one per '
          'NMS round); input voxels %s of cap %d, voxelizer overflow %s; '
          'per-level drops %s'
          % (tuple(det.loads), num, counts, launches_a,
             vox['voxel_mask'].sum(1).tolist(), det.max_voxels,
             voxel_overflow(det, pts2, mask2), drops))
    require(launches_c > 0, 'the SECOND path launched no kernel C')
    require(counts == expect, 'launches %s, want %s' % (counts, expect))

    # S4. f32 config through kernel B: GPU vs CPU at B1 ---------------------
    cfg32 = copy.deepcopy(cfg)
    cfg32.MODEL.RPN.BACKBONE.ARGS['compute_dtype_test'] = ''
    cfg32.MODEL.RPN.RPN_HEAD.ARGS['compute_dtype_test'] = ''
    outs = {}
    for name, d in (('gpu', dev), ('cpu', torch.device('cpu'))):
        det32 = second_detector(cfg32, d, sparse.ROWS)
        reset_launches()
        t0 = time.perf_counter()
        outs[name] = {k: v.cpu() for k, v in det32.detect(
            pts_all[:1].to(d), mask_all[:1].to(d)).items()}
        if name == 'gpu':
            sync()
            launches_b = gg.LAUNCHES['gather_gemm_f32']
            stray_c = gg.LAUNCHES['gather_gemm_bf16']
        print('[second S4] %s detect B1 f32: %.2f s' % (
            name, time.perf_counter() - t0))
        del det32
    g, c = outs['gpu'], outs['cpu']
    n_g, n_c = int(g['num'][0]), int(c['num'][0])
    box_err = (g['boxes'] - c['boxes']).abs().max().item()
    print('[second S4] num %d vs %d, max |box diff| %.3g; kernel B launches '
          '%d, kernel C %d' % (n_g, n_c, box_err, launches_b, stray_c))
    require(launches_b > 0, 'the f32 SECOND path launched no kernel B')
    require(stray_c == 0, 'the f32 path launched kernel C')
    require(n_g == n_c and n_g > 0, 'GPU and CPU detection counts differ')
    require(box_err <= 1e-3, 'GPU and CPU boxes differ by %g' % box_err)

    # S5. timings -----------------------------------------------------------
    print('[second S5] host books by the native builder: %s'
          % (host_books.native_lib() is not None))
    module = det.model.module
    for b in batches:
        pts, mask = pts_all[:b].contiguous(), mask_all[:b].contiguous()
        det.detect(pts, mask)
        sync()
        batch_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(10):
                det.detect(pts, mask)
            sync()
            batch_ms.append(1e3 * (time.perf_counter() - t0) / 10)
        ms = sorted(batch_ms)[1]
        t = {}
        with torch.inference_mode():
            vox = det.voxelize(pts, mask)
            t['voxelize'] = cuda_ms(lambda: det.voxelize(pts, mask), 5)
            host = {'d2h': [], 'build': [], 'h2d': []}
            for _ in range(5):
                sync()
                t0 = time.perf_counter()
                coords = vox['coordinates'].cpu().numpy()
                t1 = time.perf_counter()
                flat = det.model.build_books(coords)
                t2 = time.perf_counter()
                books = det.model.upload_books(flat, coords.shape[1])
                sync()
                t3 = time.perf_counter()
                for key, dt in (('d2h', t1 - t0), ('build', t2 - t1),
                                ('h2d', t3 - t2)):
                    host[key].append(1e3 * dt)
            host = {k: sorted(v)[2] for k, v in host.items()}

            def backbone():
                feats = module.vfe(vox['voxels'], vox['num_points_per_voxel'],
                                   vox['coordinates'], vox['voxel_mask'])
                level = sparse.from_voxelizer(feats, vox['coordinates'],
                                              vox['voxel_mask'],
                                              module.sparse_shape)
                return module.rpn_net(level, books, module.compute_dtype)[0]
            bev = backbone()
            t['backbone'] = cuda_ms(backbone, 5)
            t['rpn'] = cuda_ms(lambda: module.rpn_head(bev), 5)
            ret = module.rpn_head(bev)
            cand = candidates(det.model, ret, tc)
            t['predict'] = cuda_ms(lambda: det.model.predict(ret), 5)
            t['topk_decode'] = cuda_ms(
                lambda: candidates(det.model, ret, tc), 5)
            t['nms'] = cuda_ms(lambda: run_nms(cand, tc), 5)
        print('[second S5 B%d] detect %.2f frames/s (median of 3 runs of 10 '
              'batches; ms per batch %s); voxelize %.2f ms; books %.2f ms '
              '(coords to host %.2f, host build %.2f, upload + decode %.2f); '
              'backbone %.2f ms; RPN %.2f ms; predict %.2f ms (of it top-k + '
              'decode %.2f, NMS %.2f)' % (
                  b, 1e3 * b / ms, ', '.join('%.2f' % x for x in batch_ms),
                  t['voxelize'], host['d2h'] + host['build'] + host['h2d'],
                  host['d2h'], host['build'], host['h2d'], t['backbone'],
                  t['rpn'], t['predict'], t['topk_decode'], t['nms']))
        per_conv = conv_ms(det, vox, books)
        print('[second S5 B%d] ms per sparse conv block (conv + BN + ReLU): %s'
              % (b, ', '.join('%s %.3f' % x for x in per_conv)))
        busy, rows, ops = profile_detect(det, pts, mask)
        if not rows:
            print('[second S5 B%d] no device time recorded: not measured' % b)
            continue
        print('[second S5 B%d] device busy %.2f ms per batch of %.2f ms '
              'unprofiled: idle share %.1f%%; %d kernel names' % (
                  b, busy, ms, 100 * (1 - busy / ms), len(rows)))
        for tt, name in rows[:10]:
            print('[second S5 B%d]   kernel %7.3f ms %5.1f%%  %s' % (
                b, tt, 100 * tt / busy, name[:90]))
        for tt, name in ops[:10]:
            print('[second S5 B%d]   op     %7.3f ms %5.1f%%  %s' % (
                b, tt, 100 * tt / busy, name))
        ggk = sum(tt for tt, name in rows if 'gather_gemm' in name)
        print('[second S5 B%d] gather_gemm kernel: %.3f ms per batch (%.1f%% '
              'of device time)' % (b, ggk, 100 * ggk / busy))
    sync()

    def entry(tag, launches, replaces):
        k = kstats[tag]
        return kernel_entry('gather_gemm_' + tag,
                            'pcdet_tpu_torch/csrc/gather_gemm.cu', replaces,
                            launches, k['err'], k['ms'], k['plain_ms'],
                            k['work'])
    return [entry('f32', launches_b,
                  'pcdet_tpu/ops/pallas/gather_gemm.py:700'),
            entry('bf16', launches_c,
                  'pcdet_tpu/ops/pallas/gather_gemm.py:659')]


def dw_first_chunk(rules, blocks, kind, cin, cout, s=0):
    """Rows of a dW kernel's first chunk on this book."""
    from pcdet_tpu_torch.ops import gather_dw as gd
    b, v_out = rules.shape[:2]
    return gd.chunk_rows(b, v_out, blocks, gd.resident_blocks(
        rules.device.index, kind, cin, cout, s))


def dw_edge_rules(rules, n_in, chunk):
    """A book's rules with sample 0's second 64-row sub-tile missing every
    tap and tap 1 missing in every row of its first chunk (`chunk` rows)."""
    edge = rules.clone()
    edge[0, 64:128] = n_in
    edge[0, :chunk, 1] = n_in
    return edge


def dw_vs_plain(dev, trainer, batch, timed=True):
    """T2: kernel D against its plain version on the card, on the rules of
    real train books at conv2_1 and conv_out (and, where `timed`, kernel
    B's Cin=128 instance on conv_out's transposed book).  Each book as
    built and with `dw_edge_rules`' misses; n_live real, mid-sub-tile and
    0; two launches bitwise equal.

    :return: where `timed`, {'err', 'rel', 'ms', 'plain_ms', 'work'} of D
        at conv_out (its shape under the default loads), and {'err',
        'rel'} of B's 128 -> 64 case
    """
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import sparse
    books = batch['books']
    spec = {op[1]: op for op in trainer.model.host_book_spec(
        trainer.max_voxels, train=True)}
    cases = (   # name, rules, input mask, output mask, n_in, Cin, Cout
        ('conv2_1', books['subm2'], books['spconv2'][2], books['spconv2'][2],
         int(spec['spconv2'][5]), 32, 32),
        ('conv_out', books['convout'][4], books['spconv4'][2],
         books['convout'][2], int(spec['spconv4'][5]), 64, 128))
    gen = torch.Generator(device='cpu').manual_seed(2)
    stats = {}
    for name, rules, in_mask, out_mask, n_in, cin, cout in cases:
        b, v_out, k = rules.shape
        feats = torch.randn((b, n_in + 1, cin), generator=gen).to(dev)
        feats[:, :n_in] *= in_mask[..., None]
        feats[:, n_in] = 0
        g = torch.randn((b, v_out, cout), generator=gen).to(dev)
        live = out_mask.sum(1, dtype=torch.int32)
        mid = torch.minimum(live, torch.full_like(live, 64 * 37 + 21))
        chunk = dw_first_chunk(rules, -(-k // 3), 'rows', cin, cout)
        edge = dw_edge_rules(rules, n_in, chunk)
        errs, scale = [], 0.0
        for book in (rules, edge):
            for n_live in (live, mid, torch.zeros_like(live)):
                got = gd.gather_dw(feats, book, g, n_live)
                again = gd.gather_dw(feats, book, g, n_live)
                want = gd.gather_dw_plain(feats, book, g, n_live)
                sync()
                require(torch.equal(got, again), '%s: two launches of kernel D '
                        'differ' % name)
                errs.append((got - want).abs().max().item())
                scale = max(scale, want.abs().max().item())
        err = max(errs)
        require(err <= 1e-4 * scale, '%s B%d: kernel D vs plain %g > 1e-4 * %g'
                % (name, b, err, scale))
        msg = ('[train T2] kernel D %s (B=%d, V_out=%d, K=%d, %d x %d, live '
               '%s): max |kernel - plain| %.3g (%.3g of max |plain| %.4g; '
               'real, mid-sub-tile %s and zero n_live, on the book and with '
               'sample 0 missing every tap in rows 64-127 and tap 1 in its '
               'first chunk of %d rows); bitwise repeatable' % (
                   name, b, v_out, k, cin, cout, live.tolist(), err,
                   err / scale, scale, mid.tolist(), chunk))
        if not timed:
            print(msg)
            continue
        ms = device_ms(lambda: gd.gather_dw(feats, rules, g, live), 20)
        plain_ms = cuda_ms(lambda: gd.gather_dw_plain(feats, rules, g, live),
                           3, 1)
        print(msg + '; kernel %.4f ms (device), plain %.4f ms' % (
            ms, plain_ms))
        if name != 'conv_out':
            continue
        stats['d'] = {'err': err, 'rel': err / scale, 'ms': ms,
                      'plain_ms': plain_ms, 'work': gather_work(
                          feats, rules, live, cout, 4 * k,
                          4 * cout * int(live.sum()) + 4 * k * cin * cout)}
        # conv_out's feature gradient: B (128 -> 64) over the transposed book
        n_live_in = in_mask.sum(1, dtype=torch.int32)
        bwd = sparse.transpose_rules(rules, n_in, v_out)
        g_table = torch.cat([g, g.new_zeros((b, 1, cout))], 1)
        w_t = (torch.rand((k, cout, cin), generator=gen).to(dev) * 2 - 1) / 8
        got = gg.gather_gemm(g_table, bwd, w_t, n_live_in)
        want = gg.gather_gemm_plain(g_table, bwd, w_t, n_live_in)
        sync()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        require(err <= 1e-5 * scale, 'kernel B 128 -> 64 vs plain %g > 1e-5 '
                '* %g' % (err, scale))
        ms = cuda_ms(lambda: gg.gather_gemm(g_table, bwd, w_t, n_live_in), 20)
        plain_ms = cuda_ms(
            lambda: gg.gather_gemm_plain(g_table, bwd, w_t, n_live_in), 3, 1)
        print("[train T2] kernel B 128 -> 64 on conv_out's transposed book "
              '(B=%d, V=%d, K=%d, live %s): max |kernel - plain| %.3g (%.3g of '
              'max |plain| %.4g); kernel %.4f ms, plain %.4f ms' % (
                  b, n_in, k, n_live_in.tolist(), err, err / scale, scale, ms,
                  plain_ms))
        stats['b128'] = {'err': err, 'rel': err / scale}
    return stats


def train_step_split(trainer, batch, iters=5):
    """Median ms of the step's device parts by CUDA events: forward + loss,
    backward, optimizer."""
    model, state = trainer.model, trainer.state
    parts = {'forward': [], 'backward': [], 'optimizer': []}
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        model.train_mode()
        ret = model.forward(batch)
        loss, _ = model.loss(ret, batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, state.params)
        ev[2].record()
        state.optimizer.step(grads)
        ev[3].record()
        sync()
        for i, key in enumerate(parts):
            parts[key].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: sorted(v)[len(v) // 2] for k, v in parts.items()}


def host_stages(trainer, points, mask, gt, iters=5):
    """Median ms of make_batch's stages, each on its own: voxelize (CUDA
    events), coords to host, host book build, targets (assign), upload +
    decode (host clock, synchronised)."""
    from pcdet_tpu_torch.ops import host_books
    t = {'voxelize': [], 'd2h': [], 'build': [], 'targets': [], 'h2d': []}
    for _ in range(iters):
        sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        vox = trainer.voxelize(points, mask)
        e1.record()
        sync()
        t['voxelize'].append(e0.elapsed_time(e1))
        t0 = time.perf_counter()
        coords = vox['coordinates'].cpu().numpy()
        t1 = time.perf_counter()
        flat = trainer.model.build_books(coords, train=True)
        t2 = time.perf_counter()
        labels, reg = trainer.targets(gt)
        t3 = time.perf_counter()
        spec = trainer.model.host_book_spec(coords.shape[1], train=True)
        up = host_books.upload(host_books.wire_arrays(flat, spec) + [
            ('box_cls_labels', labels), ('box_reg_targets', reg)],
            trainer.device)
        host_books.decode_books(up, spec, coords.shape[1])
        sync()
        t4 = time.perf_counter()
        for key, dt in (('d2h', t1 - t0), ('build', t2 - t1),
                        ('targets', t3 - t2), ('h2d', t4 - t3)):
            t[key].append(1e3 * dt)
    return {k: sorted(v)[len(v) // 2] for k, v in t.items()}


def profile_train(trainer, batch, iters=3):
    """Device time per step by kernel (torch.profiler), steps on a prebuilt
    batch: (busy ms per step, [(ms per step, kernel name)] by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            trainer.step(batch)
        sync()
    rows = [(e.self_device_time_total / 1e3 / iters, e.key)
            for e in prof.key_averages()
            if e.self_device_time_total > 0
            and e.device_type == DeviceType.CUDA]
    return sum(ms for ms, _ in rows), sorted(rows, reverse=True)


def run_train(dev, cfg, batches=(2, 8), steps=5):
    """Phases T1-T5 on SECOND training; returns kernel D's JSON entry and
    kernel B's training launch counts."""
    from pcdet_tpu_torch.ops import cuda_build
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.train import train_state
    from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans

    # T1. builds (started with the others in phase 1) ---------------------
    gd.build()
    for lib in ('gather_dw', 'gather_gemm'):
        log = cuda_build.BUILD_LOG[lib]
        rows = ptxas_entries(log)
        if lib == 'gather_dw':
            require(not any(r[3] for r in rows), 'a kernel D instance spills: '
                    '%s' % rows)
        if lib == 'gather_gemm':             # its new Cin=128 instances
            rows = [r for r in rows
                    if r[1].replace('bf16,', '').split(',')[0] == '128']
        print('[train T1] %s.cu: %.2f s (cached=%s); %s' % (
            lib, log['seconds'], log['cached'], '; '.join(
                '%s<%s> %d regs, %d B spilled' % tuple(r) for r in rows)
            or 'ptxas report empty (library reused)'))

    total = 50
    trainer = build_trainer(cfg, dev, seed=0, total_steps=total)
    pts_np, mask_np, gt_np = make_train_scans(cfg, max(batches),
                                              ring_keep=0.35)
    pts_all = torch.as_tensor(pts_np, device=dev)
    mask_all = torch.as_tensor(mask_np, device=dev)
    pts2, mask2 = pts_all[:2].contiguous(), mask_all[:2].contiguous()
    batch2 = trainer.make_batch(pts2, mask2, gt_np[:2])

    # T2. kernel D (and B's new instance) vs plain ------------------------
    kstats = dw_vs_plain(dev, trainer, batch2)
    dw_vs_plain(dev, trainer, trainer.make_batch(                  # a B8 book
        pts_all[:8].contiguous(), mask_all[:8].contiguous(), gt_np[:8]),
        timed=False)

    # T3. full-width training at B2 through the kernels --------------------
    reset_launches()
    tbs = []
    t0 = time.perf_counter()
    for _ in range(steps):
        tbs.append({k: v.item() for k, v in trainer.step(batch2).items()})
    sync()
    wall = time.perf_counter() - t0
    counts = nonzero(all_launches())
    losses = [tb['loss'] for tb in tbs]
    loads = trainer.model.module.rpn_net.loads
    print('[train T3] second.yaml B2, %d steps on one batch in %.2f s: loss '
          '%s; last tb %s; voxels %s of cap %d; loads %s, launches %s' % (
              steps, wall, ', '.join('%.5f' % x for x in losses),
              {k: round(v, 5) for k, v in tbs[-1].items()
               if not k.startswith('overflow')},
              batch2['voxel_mask'].sum(1).tolist(), trainer.max_voxels,
              tuple(loads), counts))
    print('[train T3] overflow/* per step: %s' % {
        k: v for k, v in tbs[0].items() if k.startswith('overflow')})
    require(all(np.isfinite(v) for tb in tbs for v in tb.values()),
            'a non-finite loss term')
    require(losses[-1] < losses[0], 'loss did not fall in %d steps: %s'
            % (steps, losses))
    expect = forward_launches(loads, torch.float32, steps, train=True)
    require(counts == expect, 'launches over %d steps %s, want %s'
            % (steps, counts, expect))

    # T4. one train step at B1: GPU vs CPU, kernels vs plain, f64 --------
    # K32: the card through kernels B and D; P32 / P64: the card through
    # their plain versions in f32 / f64; C32 / C64: the CPU in f32 / f64.
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    names = ('gather_gemm', 'gather_gemm_xwin', 'gather_gemm_seg',
             'gather_dw', 'gather_dw_xwin', 'gather_dw_seg')
    kernels = {n: getattr(sparse, n) for n in names}
    plains = {'gather_gemm': gg.gather_gemm_plain,
              'gather_gemm_xwin': gx.gather_gemm_xwin_plain,
              'gather_gemm_seg': gx.gather_gemm_seg_plain,
              'gather_dw': gd.gather_dw_plain,
              'gather_dw_xwin': gd.gather_dw_xwin_plain,
              'gather_dw_seg': gd.gather_dw_seg_plain}
    out = {}
    for name, d, dtype in (('K32', dev, torch.float32),
                           ('P32', dev, torch.float32),
                           ('P64', dev, torch.float64),
                           ('C32', torch.device('cpu'), torch.float32),
                           ('C64', torch.device('cpu'), torch.float64)):
        if name.startswith('P'):
            for n, fn in plains.items():
                setattr(sparse, n, lambda *a, _fn=fn, dgrad=False: _fn(*a))
        try:
            tr = build_trainer(cfg, d, seed=0, total_steps=total)
            tr.model.module.to(dtype)
            t0 = time.perf_counter()
            b1 = tr.make_batch(pts_all[:1].to(d), mask_all[:1].to(d),
                               gt_np[:1])
            for key in ('voxels', 'box_reg_targets'):
                b1[key] = b1[key].to(dtype)
            loss, _, grads = train_state.loss_and_grads(
                tr.model, tr.state.params, b1)
        finally:
            for n, fn in kernels.items():
                setattr(sparse, n, fn)
        names = [n for n, _ in tr.model.module.named_parameters()]
        out[name] = (float(loss), {n: g.cpu().double()
                                   for n, g in zip(names, grads)
                                   if n.startswith('rpn_net.')
                                   and n.endswith('.0.weight')},
                     b1['coordinates'].cpu())
        print('[train T4] %s train step B1 (forward + loss + backward, batch '
              'built): %.2f s' % (name, time.perf_counter() - t0))
        del tr, b1, grads
    require(torch.equal(out['K32'][2], out['C32'][2]),
            'GPU and CPU voxel coords differ')
    rel = abs(out['K32'][0] - out['C32'][0]) / abs(out['C32'][0])
    print('[train T4] loss K32 %.7f, C32 %.7f (GPU vs CPU rel %.3g); f64: '
          'P64 %.10f, C64 %.10f' % (out['K32'][0], out['C32'][0], rel,
                                    out['P64'][0], out['C64'][0]))
    ref = out['C64'][1]

    def dw_err(a, b):
        """Per sparse conv: max |a - b| / max |C64|."""
        return {n[8:-9]: (out[a][1][n] - out[b][1][n]).abs().max().item()
                / ref[n].abs().max().item() for n in ref}
    errs = {pair: dw_err(*pair) for pair in (
        ('K32', 'P32'), ('P64', 'C64'), ('K32', 'C32'), ('K32', 'C64'),
        ('C32', 'C64'))}
    for pair, e in errs.items():
        print('[train T4] sparse conv dW %s vs %s, max error / max |dW|: %s'
              % (pair[0], pair[1], ', '.join('%s %.2e' % x for x in e.items())))
    require(rel <= 1e-4, 'GPU vs CPU loss %g relative' % rel)
    # Kernels vs their plain versions inside the same step on the card
    # (1e-3), and the same math on both devices in f64 (1e-9).  GPU f32 vs
    # CPU f32 is printed, not bounded: the card's f32 step (cuDNN's conv
    # backward in the RPN, plain or kernels alike) sits several times further
    # from the f64 step than the CPU's f32 step does.
    kp, dev64 = errs[('K32', 'P32')], errs[('P64', 'C64')]
    require(len(kp) == 12 and max(kp.values()) <= 1e-3,
            'sparse conv dW through the kernels vs plain on the card: %s' % kp)
    require(max(dev64.values()) <= 1e-9,
            'f64 sparse conv dW GPU vs CPU: %s' % dev64)

    # T5. timings -----------------------------------------------------------
    for b in batches:
        pts, mask = pts_all[:b].contiguous(), mask_all[:b].contiguous()
        gt = gt_np[:b]
        batch = trainer.make_batch(pts, mask, gt)
        trainer.step(batch)                                  # warm-up
        sync()
        full, pre = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer.step(trainer.make_batch(pts, mask, gt))
            sync()
            full.append(1e3 * (time.perf_counter() - t0) / steps)
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer.step(batch)
            sync()
            pre.append(1e3 * (time.perf_counter() - t0) / steps)
        ms_full, ms_pre = sorted(full)[1], sorted(pre)[1]
        host = host_stages(trainer, pts, mask, gt)
        dev_split = train_step_split(trainer, batch)
        print('[train T5 B%d] step with the batch built: %.2f ms (%.2f '
              'samples/s; ms per step %s); prebuilt batch: %.2f ms (%.2f '
              'samples/s; %s); median of 3 runs of %d steps' % (
                  b, ms_full, 1e3 * b / ms_full,
                  ', '.join('%.2f' % x for x in full), ms_pre,
                  1e3 * b / ms_pre, ', '.join('%.2f' % x for x in pre),
                  steps))
        print('[train T5 B%d] voxelize %.2f ms; books: to host %.2f, build '
              '%.2f, upload + decode (with targets) %.2f ms; targets (host '
              'assign) %.2f ms (%.2f per sample, %d anchors); forward + loss '
              '%.2f ms, backward %.2f ms, optimizer %.2f ms' % (
                  b, host['voxelize'], host['d2h'], host['build'],
                  host['h2d'], host['targets'], host['targets'] / b,
                  trainer.model.anchors.shape[0], dev_split['forward'],
                  dev_split['backward'], dev_split['optimizer']))
        busy, rows = profile_train(trainer, batch)
        if not rows:
            print('[train T5 B%d] no device time recorded: not measured' % b)
            continue
        def share(*keys):
            return sum(t for t, n in rows if any(k in n for k in keys))
        parts = (('B', share('gather_gemm_kernel')),
                 ("E / E'", share('gather_gemm_xwin_kernel')),
                 ('D', share('gather_dw_partial<')),
                 ("D'' / D'", share('gather_dw_xwin_partial')),
                 ("dW sum pass (D, D'', D')", share('sum_partials(')),
                 ('selectors', share('xwin_selectors_kernel')))
        idle = ('idle %.1f%% of the prebuilt step, %.1f%% of the step with '
                'the batch built' % (100 * (1 - busy / ms_pre),
                                     100 * (1 - busy / ms_full))
                if busy <= ms_pre else 'idle not measured (busy under the '
                'profiler exceeds the unprofiled prebuilt step)')
        print('[train T5 B%d] device busy %.2f ms per step: %s; %s; %d '
              'kernel names' % (b, busy, idle, ', '.join(
                  'kernel %s %.3f ms (%.1f%%)' % (k, t, 100 * t / busy)
                  for k, t in parts), len(rows)))
        for tt, name in rows[:12]:
            print('[train T5 B%d]   kernel %7.3f ms %5.1f%%  %s' % (
                b, tt, 100 * tt / busy, name[:90]))
    # the same prebuilt steps with cuDNN's autotuner choosing the RPN's
    # f32 conv algorithms (its heuristic picks FFT convolutions above)
    torch.backends.cudnn.benchmark = True
    for b in batches:
        batch = trainer.make_batch(pts_all[:b].contiguous(),
                                   mask_all[:b].contiguous(), gt_np[:b])
        for _ in range(2):
            trainer.step(batch)
        sync()
        pre = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer.step(batch)
            sync()
            pre.append(1e3 * (time.perf_counter() - t0) / steps)
        print('[train T5 B%d] prebuilt batch with torch.backends.cudnn.'
              'benchmark on: %.2f ms (%.2f samples/s; %s)' % (
                  b, sorted(pre)[1], 1e3 * b / sorted(pre)[1],
                  ', '.join('%.2f' % x for x in pre)))
    torch.backends.cudnn.benchmark = False
    sync()
    d = kstats['d']
    return (kernel_entry('gather_dw', 'pcdet_tpu_torch/csrc/gather_dw.cu',
                         'pcdet_tpu/ops/pallas/gather_gemm.py:882',
                         counts.get('gather_dw', 0), d['err'], d['ms'],
                         d['plain_ms'], d['work']),
            {'train_launches': counts.get('gather_gemm_f32', 0),
             'backward_launches': counts.get('gather_gemm_f32_dgrad', 0),
             'b128_max_abs_err': kstats['b128']['err']})


# ----------------------------------------------------------------------------
# X1-X4: the x-window and segment loads of the kw=3 sparse convs
# ----------------------------------------------------------------------------

KW3_CONVS = (   # SpConvBNReLU of BackBone8x, its book, Cin, Cout
    ('conv_input', 'subm1', 4, 16), ('conv1.0', 'subm1', 16, 16),
    ('conv2.0', 'spconv2', 16, 32), ('conv2.1', 'subm2', 32, 32),
    ('conv2.2', 'subm2', 32, 32), ('conv3.0', 'spconv3', 32, 64),
    ('conv3.1', 'subm3', 64, 64), ('conv3.2', 'subm3', 64, 64),
    ('conv4.0', 'spconv4', 64, 64), ('conv4.1', 'subm4', 64, 64),
    ('conv4.2', 'subm4', 64, 64))
SEG_SMALL = 16
GEMM_SRC = 'pcdet_tpu_torch/csrc/gather_gemm_xwin.cu'
DW_SRC = 'pcdet_tpu_torch/csrc/gather_dw_xwin.cu'
REPLACES = {'gather_gemm_xwin': 'pcdet_tpu/ops/pallas/gather_gemm.py:272',
            'gather_gemm_seg': 'pcdet_tpu/ops/pallas/gather_gemm.py:493',
            'gather_dw_xwin': 'pcdet_tpu/ops/pallas/gather_gemm.py:843',
            'gather_dw_seg': 'pcdet_tpu/ops/pallas/gather_gemm.py:577',
            # not a Pallas kernel: the XLA selector build the TPU ran
            'xwin_selectors': 'pcdet_tpu/ops/sparse.py:474'}


def level_books(books, spec, input_cap, input_mask):
    """Per book key: (rules, zero-row index of its input level, input mask,
    output mask)."""
    out, n_in, mask = {}, int(input_cap), input_mask
    for op in spec:
        key = op[1]
        if op[0] == 'subm':
            out[key] = (books[key], n_in, mask, mask)
        else:
            out[key] = (books[key][4], n_in, mask, books[key][2])
            n_in, mask = int(op[5]), books[key][2]
    return out


def bwd_book(case, subm):
    """A conv's feature-gradient book: the mirrored (subm) or transposed
    (strided) book, as (rules, n_in, input mask, output mask)."""
    from pcdet_tpu_torch.ops import sparse
    rules, n_in, in_mask, out_mask = case
    if subm:
        return rules.flip(-1), n_in, in_mask, out_mask
    n_out = rules.shape[1]
    return (sparse.transpose_rules(rules, n_in, n_out), n_out, out_mask,
            in_mask)


def rand_table(gen, case, cin, dev):
    rules, n_in, in_mask, _ = case
    t = torch.randn((rules.shape[0], n_in + 1, cin), generator=gen).to(dev)
    t[:, :n_in] *= in_mask[..., None]
    t[:, n_in] = 0
    return t


def expected_tiles(base, sel, live, s):
    """The (segment, window) (tile, group)s a segment kernel takes on the
    tiles its n_live reaches, from `segment_desc`."""
    from pcdet_tpu_torch.ops import gather_xwin as gx
    _, ok, _ = gx.segment_desc(base, sel, gx.TILE, s)
    tiles = torch.arange(ok.shape[1], device=ok.device) * gx.TILE
    reach = (tiles[None] < live[:, None])[..., None]
    ok = ok > 0
    return int((ok & reach).sum()), int((~ok & reach).sum())


def dw_edge_selectors(base, sel, chunk):
    """Selectors with sample 0's second 64-row sub-tile finding no tap and
    x-tap 1 of group 0 missing in every row of its first chunk (`chunk`
    rows): `dw_edge_rules` for D'' and D'."""
    from pcdet_tpu_torch.ops import gather_xwin as gx
    edge = sel.clone()
    edge[0, 64:128] = gx.NO_TAP
    edge[0, :chunk, 0] |= 3 << 2
    return edge


def xwin_vs_plain(dev, eval_books, train_books, train_books8):
    """X1: E, E' (f32, bf16), D'', D' against their plain versions on real
    B2 books (D'', D' also at B8).  Returns {entry name: {'err', 'ms',
    'plain_ms', 'work'}} at conv2_1 (subm2, 32 -> 32) B2."""
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    gen = torch.Generator(device='cpu').manual_seed(4)
    stats, tiles_seen = {}, [0, 0]
    # the selector kernel against its plain version on every kw=3 book, its
    # mirrored or transposed book, eval and train
    n_books = 0
    for books, tag in ((eval_books, 'eval'), (train_books, 'train')):
        for key, case in books.items():
            if key == 'convout':
                continue
            for kind, (rules, n_in, _, out_mask) in (
                    ('fwd', case), ('bwd', bwd_book(case, 'subm' in key))):
                got = sparse.xwin_selectors(rules, n_in)
                want = gx.xwin_selectors_plain(rules, n_in)
                require(all(torch.equal(a, c) for a, c in zip(got, want)),
                        'selectors of %s %s %s: kernel != plain'
                        % (tag, key, kind))
                require(int(got[2]) == 0, '%s %s %s: %d taps outside their '
                        'window' % (tag, key, kind, int(got[2])))
                n_books += 1
                if (tag, key, kind) == ('eval', 'subm2', 'fwd'):
                    ms = cuda_ms(lambda: sparse.xwin_selectors(rules, n_in),
                                 20)
                    plain_ms = cuda_ms(lambda: gx.xwin_selectors_plain(
                        rules, n_in), 5)
                    stats['xwin_selectors'] = {
                        'err': 0.0, 'ms': ms, 'plain_ms': plain_ms,
                        'work': (0, rules.numel() * 4 + 2 * got[0].numel() * 4)}
    print('[xwin X1] selectors: kernel == plain on %d books (eval and train, '
          'forward and mirrored / transposed), no tap dropped; subm2 B2: '
          'kernel %.4f ms, plain %.4f ms' % (
              n_books, stats['xwin_selectors']['ms'],
              stats['xwin_selectors']['plain_ms']))
    fwd_cases = (('conv2_1', eval_books['subm2'], 32, 32),
                 ('conv3_0', eval_books['spconv3'], 32, 64),
                 ('conv3_0 transposed', bwd_book(eval_books['spconv3'],
                                                 False), 64, 32))
    for name, case, cin, cout in fwd_cases:
        rules, n_in, _, out_mask = case
        b, v_out, k = rules.shape
        base, sel, clamped = sparse.xwin_selectors(rules, n_in)
        require(int(clamped) == 0, '%s: %d taps outside their window'
                % (name, int(clamped)))
        feats = rand_table(gen, case, cin, dev)
        w32 = (torch.rand((k, cin, cout), generator=gen) * 2 - 1).to(dev)
        w32 /= (cin * k) ** 0.5
        live = out_mask.sum(1, dtype=torch.int32)
        mid = torch.minimum(live, torch.full_like(live, 64 * 37 + 21))
        all_miss = (rules == n_in).all(-1)
        for dtype, tag in ((torch.float32, 'f32'), (torch.bfloat16, 'bf16')):
            table, w = feats.to(dtype), w32.to(dtype)
            rows_out = gg.gather_gemm(table, rules, w, live)
            for variant, s in (('xwin', 0), ('seg', gx.SEG_S),
                               ('seg', SEG_SMALL)):
                errs, scale, want_tiles = [], 0.0, [0, 0]
                gx.reset_seg_tiles()
                for n_live in (live, mid, torch.zeros_like(live)):
                    if variant == 'xwin':
                        got = gx.gather_gemm_xwin(table, base, sel, w, n_live)
                        want = gx.gather_gemm_xwin_plain(table, base, sel, w,
                                                         n_live)
                    else:
                        got = gx.gather_gemm_seg(table, base, sel, w, n_live,
                                                 s=s)
                        want = gx.gather_gemm_seg_plain(table, base, sel, w,
                                                        n_live, s=s)
                        for i, n in enumerate(expected_tiles(base, sel,
                                                             n_live, s)):
                            want_tiles[i] += n
                    sync()
                    errs.append((got - want).abs().max().item())
                    scale = max(scale, want.abs().max().item())
                    rows = torch.arange(v_out, device=dev)[None]
                    require(not bool(got[rows >= n_live[:, None]].any())
                            and not bool(got[all_miss].any()),
                            '%s %s %s: a dead or all-miss row is not zero'
                            % (name, variant, tag))
                err = max(errs)
                require(err <= 1e-5 * scale, '%s %s %s S=%d: kernel vs plain '
                        '%g > 1e-5 * %g' % (name, variant, tag, s, err, scale))
                msg = ''
                if variant == 'seg':
                    got_tiles = gx.seg_tiles()
                    got_tiles = [got_tiles['segment'], got_tiles['window']]
                    require(got_tiles == want_tiles, '%s %s S=%d: tiles %s, '
                            'the descriptors say %s' % (name, tag, s,
                                                        got_tiles, want_tiles))
                    tiles_seen = [a + c for a, c in zip(tiles_seen,
                                                        got_tiles)]
                    msg = '; (tile, group)s by segment / window %d / %d' % (
                        tuple(got_tiles))
                fn = (gx.gather_gemm_xwin if variant == 'xwin' else
                      (lambda *a, s=s: gx.gather_gemm_seg(*a, s=s)))
                got, again = (fn(table, base, sel, w, live) for _ in '12')
                same_as_b = bool(torch.equal(got, rows_out))
                require(same_as_b and torch.equal(got, again),
                        '%s %s %s S=%d: not bitwise equal to kernel %s (%s) '
                        'or to a second launch' % (
                            name, variant, tag, s, 'C' if tag == 'bf16'
                            else 'B', same_as_b))
                print('[xwin X1] %s %s %s%s (B=%d, V_out=%d, %d -> %d, live '
                      '%s, mid %s, 0): max |kernel - plain| %.3g (%.3g of max '
                      '|plain| %.4g); bitwise equal to kernel %s: %s, and to '
                      'a second launch%s' % (
                          variant, tag, name, ' S=%d' % s if s else '', b,
                          v_out, cin, cout, live.tolist(), mid.tolist(), err,
                          err / scale, scale, 'C' if tag == 'bf16' else 'B',
                          same_as_b, msg))
                if name == 'conv2_1' and s != SEG_SMALL:
                    key = 'gather_gemm_%s_%s' % (variant, tag)
                    ms = cuda_ms(lambda: fn(table, base, sel, w, live), 20)
                    plain = (gx.gather_gemm_xwin_plain if variant == 'xwin'
                             else gx.gather_gemm_seg_plain)
                    plain_ms = cuda_ms(lambda: plain(table, base, sel, w,
                                                     live), 3, 1)
                    stats[key] = {'err': err, 'ms': ms, 'plain_ms': plain_ms,
                                  'work': gather_work(
                                      table, rules, live, cout,
                                      8 * base.shape[2],
                                      w.numel() * w.element_size()
                                      + 4 * b * v_out * cout)}
                    print('[xwin X1] %s %s conv2_1: kernel %.4f ms, plain '
                          '%.4f ms' % (variant, tag, ms, plain_ms))
    for name, case, cin, cout in (
            ('conv2_1', train_books['subm2'], 32, 32),
            ('conv3_0', train_books['spconv3'], 32, 64),
            ('conv2_1 B8', train_books8['subm2'], 32, 32)):
        rules, n_in, _, out_mask = case
        b, v_out, k = rules.shape
        base, sel, clamped = sparse.xwin_selectors(rules, n_in)
        require(int(clamped) == 0, 'train %s: %d taps outside their window'
                % (name, int(clamped)))
        feats = rand_table(gen, case, cin, dev)
        g = torch.randn((b, v_out, cout), generator=gen).to(dev)
        live = out_mask.sum(1, dtype=torch.int32)
        mid = torch.minimum(live, torch.full_like(live, 64 * 37 + 21))
        for variant, s in (('xwin', 0), ('seg', gx.SEG_S), ('seg', SEG_SMALL)):
            fn = (gd.gather_dw_xwin if variant == 'xwin' else
                  (lambda *a, s=s: gd.gather_dw_seg(*a, s=s)))
            plain = (gd.gather_dw_xwin_plain if variant == 'xwin' else
                     (lambda *a, s=s: gd.gather_dw_seg_plain(*a, s=s)))
            errs, scale, want_tiles = [], 0.0, [0, 0]
            gx.reset_seg_tiles()
            edge = dw_edge_selectors(base, sel, dw_first_chunk(
                base, 9, variant, cin, cout, s))
            for sl, n_live in itertools.product(
                    (sel, edge), (live, mid, torch.zeros_like(live))):
                got = fn(feats, base, sl, g, n_live)
                again = fn(feats, base, sl, g, n_live)
                want = plain(feats, base, sl, g, n_live)
                if variant == 'seg':
                    for i, n in enumerate(expected_tiles(base, sl, n_live,
                                                         s)):
                        want_tiles[i] += 2 * n
                sync()
                require(torch.equal(got, again), 'train %s: two launches of '
                        '%s differ' % (name, variant))
                errs.append((got - want).abs().max().item())
                scale = max(scale, want.abs().max().item())
            err = max(errs)
            require(err <= 1e-4 * scale, 'train %s %s S=%d: kernel vs plain '
                    '%g > 1e-4 * %g' % (name, variant, s, err, scale))
            msg = ''
            if variant == 'seg':
                got_tiles = gx.seg_tiles()
                got_tiles = [got_tiles['segment'], got_tiles['window']]
                require(got_tiles == want_tiles, 'dW %s S=%d: tiles %s, the '
                        'descriptors say %s' % (name, s, got_tiles,
                                                want_tiles))
                tiles_seen = [a + c for a, c in zip(tiles_seen, got_tiles)]
                msg = '; (tile, group)s by segment / window %d / %d' % (
                    tuple(got_tiles))
            print('[xwin X1] dW %s %s%s (B=%d, V_out=%d, %d x %d): max |kernel'
                  ' - plain| %.3g (%.3g of max |plain| %.4g; live %s, mid %s, '
                  '0; on the selectors and their edge cases); bitwise '
                  'repeatable%s' % (
                      variant, name, ' S=%d' % s if s else '', b, v_out, cin,
                      cout, err, err / scale, scale, live.tolist(),
                      mid.tolist(), msg))
            if name == 'conv2_1' and s != SEG_SMALL:
                ms = device_ms(lambda: fn(feats, base, sel, g, live), 20)
                plain_ms = cuda_ms(lambda: plain(feats, base, sel, g, live),
                                   3, 1)
                stats['gather_dw_' + variant] = {
                    'err': err, 'ms': ms, 'plain_ms': plain_ms,
                    'work': gather_work(feats, rules, live, cout,
                                        8 * base.shape[2],
                                        4 * cout * int(live.sum())
                                        + 4 * k * cin * cout)}
                print('[xwin X1] dW %s conv2_1: kernel %.4f ms (device), '
                      'plain %.4f ms' % (variant, ms, plain_ms))
    require(min(tiles_seen) > 0, 'a segment branch never ran: %s'
            % tiles_seen)
    return stats


def head_outputs(det, pts, mask):
    """The RPN head's dense outputs of one detect batch, as f32."""
    with torch.inference_mode():
        vox = det.voxelize(pts, mask)
        ret = det.model.forward(dict(vox, books=det.books(vox)))
    return {k: ret[k].float() for k in ('cls_preds', 'box_preds',
                                        'dir_cls_preds')}


def kept_matches(preds, ref, tol=1e-3):
    """Per sample, how many of the boxes `preds` keeps lie within `tol` of a
    box `ref` keeps."""
    out = []
    for i in range(preds['num'].shape[0]):
        a = preds['boxes'][i, :int(preds['num'][i])]
        c = ref['boxes'][i, :int(ref['num'][i])]
        if not len(a) or not len(c):
            out.append(0)
            continue
        d = (a[:, None] - c[None]).abs().amax(-1)
        out.append(int((d.amin(1) <= tol).sum()))
    return out


def xwin_detect(dev, cfg, pts2, mask2):
    """X2: second.yaml detect at B2 under loads.fwd xwin and seg against the
    rows run.

    E and E' give kernel C's bits in bf16 (the shipped stack) and kernel
    B's in f32, so detect must give the rows run's num and boxes (1e-3) in
    both; the RPN head's dense outputs against the rows run's are printed.
    Returns the launches per LAUNCHES key of the bf16 runs."""
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    post = int(cfg.MODEL.TEST.NMS_POST_MAXSIZE_LAST)
    cfg32 = copy.deepcopy(cfg)
    cfg32.MODEL.RPN.BACKBONE.ARGS['compute_dtype_test'] = ''
    cfg32.MODEL.RPN.RPN_HEAD.ARGS['compute_dtype_test'] = ''
    launches = {}
    for c, tag in ((cfg, 'bf16'), (cfg32, 'f32')):
        det = second_detector(c, dev, sparse.ROWS)
        det.detect(pts2, mask2)
        ref = det.detect(pts2, mask2)
        ref_dense = head_outputs(det, pts2, mask2)
        sync()
        for fwd in ('xwin', 'seg'):
            det = second_detector(c, dev, sparse.Loads(fwd, 'rows'))
            det.detect(pts2, mask2)                      # warm-up
            sync()
            reset_launches()
            preds = det.detect(pts2, mask2)
            sync()
            counts = nonzero(all_launches())
            tiles = gx.seg_tiles()
            num = second_detect_checks(preds, post, 2)
            clamped = {k: int(v) for k, v in
                       det.model.module.rpn_net.xwin_clamped.items()}
            dense = head_outputs(det, pts2, mask2)
            rel = {k: (dense[k] - ref_dense[k]).abs().max().item()
                   / ref_dense[k].abs().max().item() for k in dense}
            same = torch.equal(preds['num'], ref['num'])
            box_err = ((preds['boxes'] - ref['boxes']).abs().max().item()
                       if same else float('inf'))
            logits = ref_dense['cls_preds']
            print('[xwin X2] detect B2 (%s sparse stack) loads.fwd=%s: num %s '
                  '(rows %s), max |box - rows box| %.3g, kept boxes within '
                  '1e-3 of a rows box %s; head outputs vs rows, max |diff| / '
                  'max |rows|: %s (class logits of the rows run in [%.3g, '
                  '%.3g]); launches %s; segment / window (tile, group)s %d / '
                  '%d; dropped taps %s' % (
                      tag, fwd, num, ref['num'].tolist(), box_err,
                      kept_matches(preds, ref), ', '.join(
                          '%s %.3g' % x for x in rel.items()),
                      logits.min().item(), logits.max().item(), counts,
                      tiles['segment'], tiles['window'], clamped))
            expect = forward_launches(det.loads,
                                      det.model.module.compute_dtype)
            require(counts == expect, 'launches %s, want %s' % (counts,
                                                                expect))
            require(not any(clamped.values()), 'dropped taps %s' % clamped)
            require(same and box_err <= 1e-3, '%s loads.fwd=%s: boxes differ '
                    'from the rows run (%s vs %s, %g)' % (
                        tag, fwd, num, ref['num'].tolist(), box_err))
            if tag == 'bf16':
                launches.update(counts)
    return launches


def sparse_dw(trainer, batch):
    """The 12 sparse convs' dW of one step (no optimizer step)."""
    from pcdet_tpu_torch.train import train_state
    _, _, grads = train_state.loss_and_grads(trainer.model,
                                             trainer.state.params, batch)
    names = [n for n, _ in trainer.model.module.named_parameters()]
    return {n[8:-9]: g for n, g in zip(names, grads)
            if n.startswith('rpn_net.') and n.endswith('.0.weight')}


def xwin_train(dev, cfg, pts, mask, gt, steps=5):
    """X3: training at B2 under (xwin, xwin), (seg, seg) and the default
    loads; one B1 step's dW against the rows step's.  Returns the launches
    per LAUNCHES key of the window runs."""
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    from pcdet_tpu_torch.train.trainer import build_trainer
    choices = [sparse.Loads('xwin', 'xwin'), sparse.Loads('seg', 'seg')]
    if sparse.DEFAULT_LOADS not in choices:
        choices.append(sparse.DEFAULT_LOADS)
    launches = {}
    for loads in choices:
        trainer = build_trainer(cfg, dev, seed=0, total_steps=50, loads=loads)
        batch = trainer.make_batch(pts[:2].contiguous(), mask[:2].contiguous(),
                                   gt[:2])
        trainer.step(batch)                          # warm-up
        sync()
        reset_launches()
        t0 = time.perf_counter()
        losses = [trainer.step(batch)['loss'].item() for _ in range(steps)]
        sync()
        wall = time.perf_counter() - t0
        counts = nonzero(all_launches())
        tiles = gx.seg_tiles()
        clamped = {k: int(v) for k, v in
                   trainer.model.module.rpn_net.xwin_clamped.items()}
        if loads in choices[:2]:
            launches.update(counts)
        print('[xwin X3] train B2 loads %s: %d steps in %.2f s, loss %s; '
              'launches %s; segment / window (tile, group)s %d / %d; dropped '
              'taps %s' % (tuple(loads), steps, wall,
                           ', '.join('%.5f' % x for x in losses), counts,
                           tiles['segment'], tiles['window'], clamped))
        expect = forward_launches(loads, torch.float32, steps, train=True)
        require(counts == expect, 'launches %s, want %s' % (counts, expect))
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                'loads %s: losses %s' % (tuple(loads), losses))
        require(not any(clamped.values()), 'dropped taps %s' % clamped)
        del trainer, batch
    ref = None
    for loads in [sparse.ROWS] + choices:
        trainer = build_trainer(cfg, dev, seed=0, total_steps=50, loads=loads)
        dw = sparse_dw(trainer, trainer.make_batch(pts[:1].contiguous(),
                                                   mask[:1].contiguous(),
                                                   gt[:1]))
        if ref is None:
            ref = dw
            continue
        errs = {k: (dw[k] - ref[k]).abs().max().item()
                / ref[k].abs().max().item() for k in ref}
        print('[xwin X3] B1 step, sparse conv dW under loads %s vs rows, max '
              'error / max |dW|: %s' % (tuple(loads), ', '.join(
                  '%s %.2e' % x for x in errs.items())))
        require(len(errs) == 12 and max(errs.values()) <= 1e-3,
                'loads %s: dW vs rows %s' % (tuple(loads), errs))
    return launches


def xwin_times(dev, cfg, eval_books, train_books, pts, mask, gt):
    """X4: kernel times per kw=3 conv at B2 and the selector builds; detect
    and train under each loads choice at B2 and B8."""
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    from pcdet_tpu_torch.train.trainer import build_trainer
    gen = torch.Generator(device='cpu').manual_seed(5)
    sums = {}

    def add(key, ms):
        sums[key] = sums.get(key, 0.0) + ms

    cache, bc = {}, []
    for conv, key, cin, cout in KW3_CONVS:
        subm = key.startswith('subm')
        if (key, cin, cout) not in cache:
            row, skips = {}, {}
            for books, tag in ((eval_books, 'eval'), (train_books, 'train')):
                case = books[key]
                rules, n_in, _, out_mask = case
                base, sel, _ = sparse.xwin_selectors(rules, n_in)
                live = out_mask.sum(1, dtype=torch.int32)
                feats = rand_table(gen, case, cin, dev)
                w = ((torch.rand((27, cin, cout), generator=gen) * 2 - 1)
                     / (27 * cin) ** 0.5).to(dev)
                dts = ((torch.bfloat16, 'bf16'),) if tag == 'eval' else (
                    (torch.float32, 'f32'),)
                for dtype, t in dts:
                    tb, wb = feats.to(dtype), w.to(dtype)
                    row['fwd_%s rows' % t] = device_ms(
                        lambda: gg.gather_gemm(tb, rules, wb, live), 10)
                    row['fwd_%s xwin' % t] = device_ms(
                        lambda: gx.gather_gemm_xwin(tb, base, sel, wb, live),
                        10)
                    row['fwd_%s seg' % t] = device_ms(
                        lambda: gx.gather_gemm_seg(tb, base, sel, wb, live),
                        10)
                    skips['fwd_' + t] = skipped_share(
                        rules, n_in, live, gg.tile_rows(dtype, cin, cout))
                if tag == 'eval':
                    row['fwd plain'] = cuda_ms(
                        lambda: gg.gather_gemm_plain(feats, rules, w, live),
                        2, 1)
                    continue
                g = torch.randn((rules.shape[0], rules.shape[1], cout),
                                generator=gen).to(dev)
                row['dw rows'] = device_ms(
                    lambda: gd.gather_dw(feats, rules, g, live), 10)
                row['dw xwin'] = device_ms(
                    lambda: gd.gather_dw_xwin(feats, base, sel, g, live), 10)
                row['dw seg'] = device_ms(
                    lambda: gd.gather_dw_seg(feats, base, sel, g, live), 10)
                row['dw plain'] = cuda_ms(
                    lambda: gd.gather_dw_plain(feats, rules, g, live), 2, 1)
                if conv == 'conv_input':       # no feature gradient
                    continue
                bcase = bwd_book(case, subm)
                brules, bn_in, _, bout = bcase
                bb, bs, _ = sparse.xwin_selectors(brules, bn_in)
                blive = bout.sum(1, dtype=torch.int32)
                g_table = rand_table(gen, bcase, cout, dev)
                wt = w.transpose(1, 2).contiguous()
                row['dgrad rows'] = device_ms(lambda: gg.gather_gemm(
                    g_table, brules, wt, blive, dgrad=True), 10)
                row['dgrad xwin'] = device_ms(lambda: gx.gather_gemm_xwin(
                    g_table, bb, bs, wt, blive), 10)
                row['dgrad seg'] = device_ms(lambda: gx.gather_gemm_seg(
                    g_table, bb, bs, wt, blive), 10)
                skips['dgrad'] = skipped_share(
                    brules, bn_in, blive, gg.tile_rows(torch.float32, cout,
                                                       cin))
            cache[(key, cin, cout)] = row, skips
        row, skips = cache[(key, cin, cout)]
        bc.append((conv, row['fwd_f32 rows'], row.get('dgrad rows'),
                   row['fwd_bf16 rows']))
        for k, ms in row.items():
            if not (conv == 'conv_input' and k.startswith('dgrad')):
                add(k, ms)
        print('[xwin X4] %-10s %-7s %2d -> %-3d %s; (tile, tap) pairs kernels '
              'B / C skip: %s' % (
                  conv, key, cin, cout, ', '.join('%s %.4f' % x
                                                  for x in row.items()),
                  ', '.join('%s %.1f%%' % (k, 100 * v)
                            for k, v in skips.items())))
    print('[xwin X4] sums over the 11 kw=3 convs (ms, B2): %s' % ', '.join(
        '%s %.4f' % x for x in sums.items()))
    # conv_out (K = 3, not kw=3): B forward 64 -> 128 and feature gradient
    # 128 -> 64 on the train book, C forward on the eval book
    times = {}
    for books, dtype, kind in ((train_books, torch.float32, 'fwd_f32'),
                               (train_books, torch.float32, 'dgrad'),
                               (eval_books, torch.bfloat16, 'fwd_bf16')):
        case = books['convout'] if kind != 'dgrad' else bwd_book(
            books['convout'], False)
        rules, n_in, _, out_mask = case
        live = out_mask.sum(1, dtype=torch.int32)
        cin, cout = (128, 64) if kind == 'dgrad' else (64, 128)
        table = rand_table(gen, case, cin, dev).to(dtype)
        w = ((torch.rand((rules.shape[2], cin, cout), generator=gen) * 2 - 1)
             / (rules.shape[2] * cin) ** 0.5).to(dev).to(dtype)
        times[kind] = device_ms(lambda: gg.gather_gemm(
            table, rules, w, live, dgrad=kind == 'dgrad'), 10)
        print('[xwin X4] conv_out %s %d -> %d (V_out %d, live %s): kernel %s '
              '%.4f ms; (tile, tap) pairs skipped %.1f%%' % (
                  kind, cin, cout, rules.shape[1], live.tolist(),
                  'C' if dtype == torch.bfloat16 else 'B', times[kind],
                  100 * skipped_share(rules, n_in, live, gg.tile_rows(
                      dtype, cin, cout))))
    bc.append(('conv_out', times['fwd_f32'], times['dgrad'],
               times['fwd_bf16']))
    b_step = sum(f + (d or 0.0) for _, f, d, _ in bc)
    c_batch = sum(c for _, _, _, c in bc)
    print('[xwin X4] kernel B per train step at B2 (12 forward + 11 feature '
          'gradient launches, device time): %.4f ms; kernel C per detect '
          'batch at B2 (12 launches): %.4f ms; per conv (B forward, B '
          'feature gradient, C): %s' % (b_step, c_batch, '; '.join(
              '%s %.4f %s %.4f' % (n, f, '-' if d is None else '%.4f' % d, c)
              for n, f, d, c in bc)))
    totals = {}
    for direction, keys in (('detect forward (bf16)', ('fwd_bf16',)),
                            ('train forward + feature gradient (f32)',
                             ('fwd_f32', 'dgrad')),
                            ('train dW', ('dw',))):
        tot = {v: sum(sums['%s %s' % (k, v)] for k in keys)
               for v in ('rows', 'xwin', 'seg')}
        totals[direction] = tot
        print('[xwin X4] %s: rows %.4f ms, xwin %.4f ms (%+.1f%%), seg %.4f '
              'ms (%+.1f%%)' % (direction, tot['rows'], tot['xwin'],
                                100 * (tot['xwin'] / tot['rows'] - 1),
                                tot['seg'], 100 * (tot['seg'] / tot['rows']
                                                    - 1)))
    # the per-step book work each choice adds: selectors of the 7 kw=3
    # books, the mirrored books' (4) and the transposed books' (3)
    keys = ('subm1', 'spconv2', 'subm2', 'spconv3', 'subm3', 'spconv4',
            'subm4')

    def selectors_fwd(books=train_books):
        return [sparse.xwin_selectors(*books[k][:2]) for k in keys]

    def selectors_bwd():
        out = []
        for k in keys:
            rules, n_in = train_books[k][:2]
            base, sel, _ = sparse.xwin_selectors(rules, n_in)
            if k.startswith('subm'):
                out.append(sparse.mirror_xwin(base, sel))
            else:
                n_out = rules.shape[1]
                out.append(sparse.xwin_selectors(
                    sparse.transpose_rules(rules, n_in, n_out), n_out))
        return out
    def selectors_plain():
        return [gx.xwin_selectors_plain(*train_books[k][:2]) for k in keys]
    # what a window loads.fwd adds to a train step over the default, which
    # builds the forward books' selectors (for D') and transposes the
    # strided books (for B's feature gradient) either way: the mirrored
    # books' selectors and the transposed books', in place of the mirrored
    # books' rules
    fwd_sel = dict(zip(keys, selectors_fwd()))
    transposed = {k: sparse.transpose_rules(train_books[k][0],
                                            train_books[k][1],
                                            train_books[k][0].shape[1])
                  for k in keys if not k.startswith('subm')}

    def selectors_added():
        return [sparse.mirror_xwin(*fwd_sel[k][:2]) if k.startswith('subm')
                else sparse.xwin_selectors(transposed[k],
                                           train_books[k][0].shape[1])
                for k in keys]

    def mirrored():
        return [train_books[k][0].flip(-1) for k in keys if 'subm' in k]
    t_sel = {'fwd': cuda_ms(selectors_fwd, 10),
             'plain': cuda_ms(selectors_plain, 10),
             'bwd': cuda_ms(selectors_bwd, 10),
             'eval': cuda_ms(lambda: selectors_fwd(eval_books), 10),
             'added': cuda_ms(selectors_added, 10),
             'mirror': cuda_ms(mirrored, 10)}
    print('[xwin X4] selector builds per step at B2 (train books): forward '
          '%.4f ms (by PyTorch ops %.4f ms), forward + backward books %.4f '
          'ms; mirrored books (rows) %.4f ms; the eval books\' forward '
          'selectors %.4f ms' % (t_sel['fwd'], t_sel['plain'], t_sel['bwd'],
                                 t_sel['mirror'], t_sel['eval']))
    # each choice's whole cost: its kernels plus the book work it adds over
    # the default (rows, seg)
    det = totals['detect forward (bf16)']
    trn = totals['train forward + feature gradient (f32)']
    print('[xwin X4] whole cost per choice at B2, kernels + the selector '
          'builds added over the default: detect forward (bf16): rows %.4f '
          'ms; xwin %.4f + %.4f = %.4f ms; seg %.4f + %.4f = %.4f ms (the 7 '
          'eval books\' selectors)' % (
              det['rows'], det['xwin'], t_sel['eval'],
              det['xwin'] + t_sel['eval'], det['seg'], t_sel['eval'],
              det['seg'] + t_sel['eval']))
    print('[xwin X4] whole cost per choice at B2: train forward + feature '
          'gradient (f32): rows %.4f + %.4f = %.4f ms (the mirrored books); '
          'xwin %.4f + %.4f = %.4f ms; seg %.4f + %.4f = %.4f ms (the '
          'mirrored and transposed books\' selectors)' % (
              trn['rows'], t_sel['mirror'], trn['rows'] + t_sel['mirror'],
              trn['xwin'], t_sel['added'], trn['xwin'] + t_sel['added'],
              trn['seg'], t_sel['added'], trn['seg'] + t_sel['added']))
    del fwd_sel, transposed

    # end to end: detect under each loads.fwd, in two passes
    dets = {fwd: second_detector(cfg, dev, sparse.Loads(fwd, 'rows'))
            for fwd in ('rows', 'xwin', 'seg')}
    for b in (2, 8):
        p, m = pts[:b].contiguous(), mask[:b].contiguous()
        for order in (('rows', 'xwin', 'seg'), ('seg', 'xwin', 'rows')):
            for fwd in order:
                det = dets[fwd]
                det.detect(p, m)
                sync()
                runs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    for _ in range(5):
                        det.detect(p, m)
                    sync()
                    runs.append(1e3 * (time.perf_counter() - t0) / 5)
                module = det.model.module
                with torch.inference_mode():
                    vox = det.voxelize(p, m)
                    books = det.books(vox)
                    feats = module.vfe(vox['voxels'],
                                       vox['num_points_per_voxel'],
                                       vox['coordinates'], vox['voxel_mask'])
                    level = sparse.from_voxelizer(
                        feats, vox['coordinates'], vox['voxel_mask'],
                        module.sparse_shape)
                    backbone = cuda_ms(lambda: module.rpn_net(
                        level, books, module.compute_dtype), 5)
                ms = sorted(runs)[1]
                print('[xwin X4 B%d] detect loads.fwd=%s: %.2f frames/s (ms '
                      'per batch %s); backbone %.3f ms (CUDA events)' % (
                          b, fwd, 1e3 * b / ms, ', '.join('%.2f' % x
                                                          for x in runs),
                          backbone))
    del dets
    # end to end: the prebuilt train step under each loads choice
    choices = (sparse.ROWS, sparse.Loads('xwin', 'rows'),
               sparse.Loads('seg', 'rows'), sparse.Loads('rows', 'xwin'),
               sparse.Loads('rows', 'seg'))
    for b in (2, 8):
        for loads in choices:
            trainer = build_trainer(cfg, dev, seed=0, total_steps=50,
                                    loads=loads)
            batch = trainer.make_batch(pts[:b].contiguous(),
                                       mask[:b].contiguous(), gt[:b])
            trainer.step(batch)
            sync()
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(3):
                    trainer.step(batch)
                sync()
                runs.append(1e3 * (time.perf_counter() - t0) / 3)
            split = train_step_split(trainer, batch, 3)
            ms = sorted(runs)[1]
            print('[xwin X4 B%d] train loads %s: prebuilt step %.2f ms (%.2f '
                  'samples/s; %s); forward + loss %.2f ms, backward %.2f ms, '
                  'optimizer %.2f ms (CUDA events)' % (
                      b, tuple(loads), ms, 1e3 * b / ms,
                      ', '.join('%.2f' % x for x in runs), split['forward'],
                      split['backward'], split['optimizer']))
            del trainer, batch
    sync()


def run_xwin(dev, cfg):
    """Phases X1-X4; returns the JSON entries of E, E', D'' and D'."""
    from pcdet_tpu_torch.ops import sparse
    from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans
    pts_np, mask_np, gt_np = make_train_scans(cfg, 8, ring_keep=0.35)
    pts = torch.as_tensor(pts_np, device=dev)
    mask = torch.as_tensor(mask_np, device=dev)
    pts2, mask2 = pts[:2].contiguous(), mask[:2].contiguous()

    det = second_detector(cfg, dev, sparse.ROWS)
    with torch.inference_mode():
        vox = det.voxelize(pts2, mask2)
        books = det.books(vox)
    eval_books = level_books(books, det.model.host_book_spec(det.max_voxels),
                             det.max_voxels, vox['voxel_mask'])
    trainer = build_trainer(cfg, dev, seed=0, loads=sparse.ROWS)
    train_spec = trainer.model.host_book_spec(trainer.max_voxels, train=True)
    batch = trainer.make_batch(pts2, mask2, gt_np[:2])
    train_books = level_books(batch['books'], train_spec, trainer.max_voxels,
                              batch['voxel_mask'])
    batch8 = trainer.make_batch(pts, mask, gt_np)
    train_books8 = level_books(batch8['books'], train_spec,
                               trainer.max_voxels, batch8['voxel_mask'])
    del det, trainer, batch8

    stats = xwin_vs_plain(dev, eval_books, train_books, train_books8)  # X1
    launches = xwin_detect(dev, cfg, pts2, mask2)                # X2
    launches.update(xwin_train(dev, cfg, pts, mask, gt_np))      # X3
    xwin_times(dev, cfg, eval_books, train_books, pts, mask, gt_np)  # X4

    entries = []
    for name in ('gather_gemm_xwin_f32', 'gather_gemm_xwin_bf16',
                 'gather_gemm_seg_f32', 'gather_gemm_seg_bf16',
                 'gather_dw_xwin', 'gather_dw_seg', 'xwin_selectors'):
        st = stats[name]
        n = launches.get(name, 0) + launches.get(name + '_dgrad', 0)
        require(n > 0, '%s: no launch on its main path' % name)
        base = name.rsplit('_', 1)[0] if 'gemm' in name else name
        entries.append(kernel_entry(
            name, DW_SRC if 'dw' in name else GEMM_SRC, REPLACES[base], n,
            st['err'], st['ms'], st['plain_ms'], st['work']))
    return entries


# --------------------------------------------------------------- eval ---

def overlap_work(ca, cb):
    """(operations, bytes) of one overlap grid: the cull's operations on
    every pair; on the pairs the plain cull predicate keeps (the pairs
    whose area is not provably 0 on these inputs), nothing more where A is
    one finite point and B finite (the area is +0.0), the closed form's
    where B is one finite point and A finite, the clipping's on the rest;
    the corners read once and the areas written once.  The least work for
    the function, so A, A' and A'' share it as their bound."""
    from pcdet_tpu_torch.ops import rotated_overlap as ro

    def kinds(c):        # (finite, one point) per quad
        return (torch.isfinite(c).flatten(-2).all(-1),
                (c == c[..., :1, :]).flatten(-2).all(-1))

    pairs = ca.shape[0] * ca.shape[1] * cb.shape[1]
    keep = ro.overlap_maybe_nonzero_plain(ca, cb)
    (fin_a, pt_a), (fin_b, pt_b) = kinds(ca), kinds(cb)
    finite = fin_a[:, :, None] & fin_b[:, None]
    a_point = finite & pt_a[:, :, None]
    b_point = finite & pt_b[:, None] & ~a_point
    clipped = int((keep & ~a_point & ~b_point).sum())
    return (CULL_OPS_PER_PAIR * pairs + A_OPS_PER_PAIR * clipped
            + POINT_B_OPS_PER_PAIR * int((keep & b_point).sum()),
            4 * (ca.numel() + cb.numel() + pairs))


def overlap_times(ca, cb, iters=20):
    """Kernel ms and plain ms of A, A' (group 0, G = 1) and A'' on one
    grid, on CUDA events, with each one's max |kernel - plain| and bound.
    The kernel's 'ms' is queued behind a spin (`queued_ms`): A and A' at
    these shapes take less than their Python launch; 'launch_ms' is the
    plain event loop, launch included."""
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    a0, b0 = ca[:1].contiguous(), cb[:1].contiguous()
    cases = {
        'A': (lambda: ro.pair_overlap_batched(ca, cb),
              lambda: ro.pair_overlap_batched_plain(ca, cb), (ca, cb)),
        "A'": (lambda: ro.pair_overlap(a0[0], b0[0]),
               lambda: ro.pair_overlap_batched_plain(a0, b0)[0], (a0, b0)),
        "A''": (lambda: ro.pair_overlap_sorted_batched(ca, cb),
                lambda: ro.pair_overlap_sorted_plain(ca, cb), (ca, cb)),
    }
    out = {}
    for name, (kernel, plain, grid) in cases.items():
        got, want = kernel(), plain()
        sync()
        ms, host_ms = queued_ms(kernel, iters)
        out[name] = {'err': (got - want).abs().max().item(), 'ms': ms,
                     'host_ms': host_ms, 'launch_ms': cuda_ms(kernel, iters),
                     'plain_ms': cuda_ms(plain, 3, 1),
                     'work': overlap_work(*grid)}
        out[name]['bound_ms'] = bound_ms(*out[name]['work'])[0]
    return out


def print_overlap_times(tag, shape, times, iters=20):
    print('[eval V4] %s %s: %s' % (tag, shape, '; '.join(
        '%s kernel %.4f ms (%.4f ms a call with its launch; %d calls '
        'enqueued in %.2f ms), plain %.4f ms, bound %.4f ms, max |kernel - '
        'plain| %.3g' % (k, t['ms'], t['launch_ms'], iters, t['host_ms'],
                         t['plain_ms'], t['bound_ms'], t['err'])
        for k, t in times.items())))


class RecallCrossCheck:
    """Stands in for the eval loop's `batch_recall`: the counts come from
    kernel A as before; kernel A's overlaps of each recall grid are kept,
    kernel A'' runs on the same grid (A's cross-check on the card), and the
    counts from A'''s overlaps are kept beside A's."""

    def __init__(self):
        self.grids = []

    def __call__(self, boxes, valid, gt_boxes, thresh_list):
        from pcdet_tpu_torch.models import detector3d
        from pcdet_tpu_torch.ops import rotated_overlap as ro
        grid = {}

        def kernel_a(ca, cb):
            before = ro.LAUNCHES
            grid.update(ca=ca, cb=cb, a=ro.pair_overlap_batched(ca, cb))
            grid['a_launches'] = ro.LAUNCHES - before
            return grid['a']

        counts = detector3d.batch_recall(boxes, valid, gt_boxes, thresh_list,
                                         kernel_a)
        grid['a2'] = ro.pair_overlap_sorted_batched(grid['ca'], grid['cb'])
        grid['counts_a2'] = detector3d.batch_recall(
            boxes, valid, gt_boxes, thresh_list, lambda ca, cb: grid['a2'])
        grid.update(counts=counts, boxes=boxes, valid=valid, gt=gt_boxes,
                    thresh=thresh_list)
        self.grids.append(grid)
        return counts


def eval_config(path):
    """The shipped config at `path` with the evaluation's scenes."""
    from pcdet_tpu_torch import detect as detect_mod
    cfg = detect_mod.load_config(path)
    cfg.DATA_CONFIG.SYNTHETIC = dict(EVAL_SYNTHETIC)
    return cfg


def eval_detector(cfg, dev):
    """Random weights from seed 0, conv_cls's bias zeroed (the focal prior
    keeps every score under SCORE_THRESH otherwise)."""
    from pcdet_tpu_torch import detect as detect_mod
    det = detect_mod.build_detector(cfg, dev, seed=0)
    with torch.no_grad():
        det.model.module.rpn_head.conv_cls.bias.zero_()
    return det


def run_eval_checked(det, dataset, batches, cfg):
    """eval_one_epoch with the recall through `RecallCrossCheck`; the
    launch counters set to 0 just before and read just after.  Returns
    (result dict, checker, {counter: launches})."""
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    from pcdet_tpu_torch.train import eval_loop
    checker = RecallCrossCheck()
    real = eval_loop.batch_recall
    eval_loop.batch_recall = checker
    try:
        reset_launches()
        ro.LAUNCHES = 0
        ro.LAUNCHES_SORTED = 0
        result = eval_loop.eval_one_epoch(det, iter(batches), dataset, cfg)
        sync()
        counts = dict(nonzero(all_launches()), rotated_overlap=ro.LAUNCHES,
                      rotated_overlap_sorted=ro.LAUNCHES_SORTED)
    finally:
        eval_loop.batch_recall = real
    return result, checker, counts


def eval_checks(name, result, checker, counts):
    keys = ['recall/gt', 'recall/rcnn_0.5', 'recall/rcnn_0.7'] + [
        'Car_%s_%s' % (m, d) for m in ('3d', 'bev', 'image')
        for d in ('easy', 'moderate', 'hard')]
    keys += sorted(k for k in result if k.startswith('overflow/'))
    keys.append('sec_per_example')
    print('[eval V2] %s: %s' % (name, ', '.join(
        '%s %s' % (k, result[k]) for k in keys)))
    recall_a = sum(g['a_launches'] for g in checker.grids)
    print('[eval V2] %s launches: A %d (of them %d for recall, one per batch '
          'of %d), A\'\' %d; sparse convs %s' % (
              name, counts['rotated_overlap'], recall_a, len(checker.grids),
              counts['rotated_overlap_sorted'],
              {k: v for k, v in counts.items()
               if not k.startswith('rotated_overlap')}))
    require(result['recall/gt'] > 0, '%s: recall/gt is 0' % name)
    require(all(np.isfinite(float(v)) for v in result.values()),
            '%s: a result is not finite' % name)
    require(recall_a == len(checker.grids) > 0,
            '%s: kernel A not launched once per recall grid' % name)
    require(counts['rotated_overlap_sorted'] == len(checker.grids),
            '%s: kernel A\'\' not launched on every recall grid' % name)


def cross_checks(name, checker, far_tol=5e-4):
    """V3 (a) A'' against A over every live pair (valid prediction x real
    GT) of every recall grid, counts from either equal; (b) the card's
    counts against the same predictions counted on the CPU through the plain
    version.  A zero-padded GT row is a zero-area quad, outside both
    methods' domain (every point lies on its edges, so each returns some
    area); the recall masks those pairs, and so does (a)."""
    from pcdet_tpu_torch.models import detector3d
    from pcdet_tpu_torch.ops import rotated_iou
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    worst, worst_r, knife, n_live, n_pos = 0.0, 0.0, [], 0, 0
    for i, g in enumerate(checker.grids):
        gt_valid = g['gt'][..., :7].abs().sum(-1) > 0
        live = g['valid'][..., :, None] & gt_valid[..., None, :]
        n_live += int(live.sum())
        n_pos += int((live & (g['a'] > 0)).sum())
        diff = torch.where(live, (g['a'] - g['a2']).abs(), 0.0)
        d = diff.max().item()
        if d > worst:
            idx = np.unravel_index(int(diff.argmax()), diff.shape)
            worst = d
            worst_r = float(torch.linalg.vector_norm(
                g['gt'][idx[0], idx[2], :2]).item())
        require(d <= far_tol, '%s grid %d: |A - A\'\'| %g > %g'
                % (name, i, d, far_tol))
        a_counts = {k: int(v) for k, v in g['counts'].items()}
        a2_counts = {k: int(v) for k, v in g['counts_a2'].items()}
        require(a_counts == a2_counts, '%s grid %d: recall through A %s, '
                'through A\'\' %s' % (name, i, a_counts, a2_counts))
        require(torch.equal(g['a'], ro.pair_overlap_batched_plain(
            g['ca'], g['cb'])), '%s grid %d: kernel A not bitwise equal to '
            'plain' % (name, i))
        cpu = detector3d.batch_recall(g['boxes'].cpu(), g['valid'].cpu(),
                                      g['gt'].cpu(), g['thresh'])
        cpu = {k: int(v) for k, v in cpu.items()}
        require(cpu == a_counts, '%s grid %d: card %s, CPU %s'
                % (name, i, a_counts, cpu))
        iou = rotated_iou.boxes_iou3d_batched(
            g['boxes'], g['gt'][..., :7], lambda ca, cb: g['a'])
        for t in g['thresh']:
            near = live & ((iou - t).abs() < 1e-3)
            for j in near.nonzero().tolist()[:4]:
                knife.append('grid %d pair %s IoU %.6f (A) vs %.6f (A\'\')' % (
                    i, tuple(j), iou[tuple(j)].item(),
                    rotated_iou.boxes_iou3d_batched(
                        g['boxes'], g['gt'][..., :7],
                        lambda ca, cb: g['a2'])[tuple(j)].item()))
    print('[eval V3] %s (a) max |A - A\'\'| over the %d live pairs (%d with '
          'overlap) of %d recall grids %.3g m^2 (GT at %.1f m), bound %g; '
          'recall through A\'\' == through A; pairs within 1e-3 of a '
          'threshold: %s' % (
              name, n_live, n_pos, len(checker.grids), worst, worst_r,
              far_tol, '; '.join(knife) or 'none'))
    print('[eval V3] %s (b) recall on the card == the same predictions '
          'counted on the CPU (plain version), every batch; kernel A bitwise '
          'equal to its plain version on every recall grid' % name)


def oracle_check(dev, dataset, batches, cfg):
    """V3 (c): the GT given as detections (score 1, valid, its label)
    through `batch_recall` and the evaluator: recall 1.0, AP 100."""
    from pcdet_tpu_torch.models import detector3d
    thresh = tuple(cfg.MODEL.TEST.RECALL_THRESH_LIST)
    names = list(cfg.CLASS_NAMES)
    total, annos = None, []
    for batch in batches:
        gt = torch.as_tensor(batch['gt_boxes'], device=dev)
        gt_valid = gt[..., :7].abs().sum(-1) > 0
        rc = detector3d.batch_recall(gt[..., :7], gt_valid, gt, thresh)
        total = rc if total is None else {k: total[k] + v
                                          for k, v in rc.items()}
        host = batch['gt_boxes']
        annos += dataset.generate_annotations(batch, {
            'boxes': host[..., :7], 'scores': np.ones(host.shape[:2]),
            'labels': host[..., 7].astype(np.int32),
            'valid': gt_valid.cpu().numpy()}, names)
    total = {k: int(v) for k, v in total.items()}
    _, ap = dataset.evaluation(annos, names)
    present = sorted({str(n) for a in dataset.gt_annos() for n in a['name']})
    aps = {k: float(v) for k, v in ap.items()
           if k.split('_')[0] in present and 'aos' not in k}
    print('[eval V3] (c) oracle: recall %s; AP of %s: min %.4f over %d keys'
          % (total, present, min(aps.values()), len(aps)))
    require(all(v == total['gt'] for v in total.values()) and total['gt'] > 0,
            'oracle recall is not 1.0: %s' % total)
    require(len(aps) == 18 * len(present) and min(aps.values()) >= 99.99,
            'oracle AP below 99.99: %s' % {k: v for k, v in aps.items()
                                           if v < 99.99})


def eval_split(det, dataset, batches, cfg):
    """Host seconds of the eval's stages over the batches, each stage
    ending in a synchronise: detect (upload, forward, predict), recall,
    annotate (fetch and annotations), evaluate.  Also the first batch's
    recall grid (corners of predictions and GT)."""
    from pcdet_tpu_torch.models import detector3d
    from pcdet_tpu_torch.ops import rotated_iou
    thresh = tuple(cfg.MODEL.TEST.RECALL_THRESH_LIST)
    names = list(cfg.CLASS_NAMES)
    t = {}
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        preds, gts = [], []
        for batch in batches:
            pts = torch.as_tensor(batch['points'], device=det.device)
            mask = torch.as_tensor(batch['point_mask'], device=det.device)
            preds.append(det.model.predict(det.forward(pts, mask)[1]))
            gts.append(torch.as_tensor(batch['gt_boxes'], device=det.device))
        sync()
        t['detect'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for p, gt in zip(preds, gts):
            detector3d.batch_recall(p['boxes'], p['valid'], gt, thresh)
        sync()
        t['recall'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        annos = []
        for batch, p in zip(batches, preds):
            host = {k: v.cpu().numpy() for k, v in p.items()}
            annos += dataset.generate_annotations(batch, host, names)
        t['annotate'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dataset.evaluation(annos, names)
        t['evaluate'] = time.perf_counter() - t0
    grid = (rotated_iou.boxes7_to_corners(preds[0]['boxes']),
            rotated_iou.boxes7_to_corners(gts[0][..., :7]))
    return t, grid


def run_eval(dev, g1_launches, cfgs):
    """Phases V1-V4; returns the JSON entries of A' and A''.

    :param g1_launches: kernel A's launches at G = 1 (A') in phase 5's B1
        detect
    :param cfgs: {name: config} of the evaluations, SECOND's first
    """
    from pcdet_tpu_torch.datasets.synthetic import (SyntheticDataset,
                                                    eval_batches)
    from pcdet_tpu_torch.ops import cuda_build, rotated_iou
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    from pcdet_tpu_torch.train.eval_loop import eval_one_epoch

    # V1. kernel A'' vs its plain version -----------------------------------
    def corners(*boxes):
        return tuple(rotated_iou.boxes5_to_corners(torch.as_tensor(
            x, device=dev)).contiguous() for x in boxes)

    def equal_nan(x, y):            # torch.equal, NaN equal to NaN
        nx, ny = x.isnan(), y.isnan()
        return torch.equal(nx, ny) and torch.equal(x.masked_fill(nx, 0),
                                                   y.masked_fill(ny, 0))

    rng = np.random.RandomState(2)
    cb, = corners(rand_boxes5(rng, (2, 4096)))
    sets = {'NMS shape': (cb[:, :64].contiguous(), cb)}
    cb, = corners(near_boxes5(rng, (2, 4096)))
    sets['within 6 m'] = (cb[:, :64].contiguous(), cb)
    rng = np.random.RandomState(0)       # the CPU test's 12 x 140 boxes
    sets['12 x 140 within 6 m'] = corners(near_boxes5(rng, 12)[None],
                                          near_boxes5(rng, 140)[None])
    sets['crafted'] = corners(*(x[None] for x in crafted_boxes5()))
    # |A'' - A|: both round on raw f32 coordinates, so the bound grows with
    # the range, most at slivers (nearly parallel edges).  2e-5 within 6 m
    # on the CPU test's boxes; over 524,288 pairs within 6 m 1.34e-4 on an
    # H100; at the NMS shape (centres to 42 m) a 0.005 m^2 sliver at 30 m
    # differs by 1.12e-3 (A 7.7e-4 off the f64 area, A'' 3.5e-4).  The sets
    # after these hold zero-padded rows and degenerate quads, on which A
    # and A'' return different areas of no meaning: kernel vs plain only
    vs_a_tol = {'NMS shape': 2e-3, 'within 6 m': 2e-4,
                '12 x 140 within 6 m': 2e-5, 'crafted': 2e-5}
    sets['B8 recall grid'] = tuple(
        rotated_iou.boxes7_to_corners(torch.as_tensor(x, device=dev))
        for x in recall_grid_boxes7(np.random.RandomState(4)))
    sets['NMS shape, degenerate quads'] = degenerate_quads(*sets['NMS shape'])
    quads = torch.as_tensor(np.concatenate(list(
        sorted_crafted_quads().values())), device=dev)[None].contiguous()
    sets['crafted quads'] = (quads, quads)
    a, b = (x.clone() for x in sets['12 x 140 within 6 m'])
    a[0, 3, 1, 0] = float('nan')
    b[0, 7, 2, 1] = float('inf')
    sets['a NaN and an Inf corner'] = (a, b)
    quads = torch.as_tensor(overflow_quads(), device=dev)[None].contiguous()
    sets['overflowing corners'] = (quads, quads)
    v1_err = 0.0
    for tag, (a, b) in sets.items():
        got = ro.pair_overlap_sorted_batched(a, b)
        again = ro.pair_overlap_sorted_batched(a, b)
        want = ro.pair_overlap_sorted_plain(a, b)
        sync()
        err = (got - want).abs().nan_to_num(nan=0.0).max().item()
        line = ("[eval V1] A'' %s %s: max |kernel - plain| %.3g, bitwise "
                "equal %s, two launches bitwise equal %s; %d pairs > 0, %d "
                "not finite" % (tag, tuple(got.shape), err,
                                equal_nan(got, want), equal_nan(got, again),
                                int((want > 0).sum()),
                                int((~want.isfinite()).sum())))
        require(equal_nan(got, want), "A'' %s: kernel vs plain %g"
                % (tag, err))
        require(equal_nan(got, again), "A'' %s: launches differ" % tag)
        require(tag != 'overflowing corners' or bool(
            want.isnan().any() and want.isposinf().any()),
            "A'' overflowing corners: no area of +inf and NaN")
        v1_err = max(v1_err, err)
        if tag not in vs_a_tol:
            print(line)
            continue
        edge = ro.pair_overlap_batched(a, b)
        diff = (got - edge).abs()
        g, i, j = np.unravel_index(int(diff.argmax()), diff.shape)
        f64 = rotated_iou.quad_intersection_area(a[g, i].double(),
                                                 b[g, j].double()).item()
        print("%s; max |A'' - A| %.3g (bound %g; %d pairs over 2e-5) at a "
              "pair of area %.6f (A'') / %.6f (A) / %.6f (f64)" % (
                  line, diff.max().item(), vs_a_tol[tag],
                  int((diff > 2e-5).sum()), got[g, i, j].item(),
                  edge[g, i, j].item(), f64))
        require(diff.max().item() <= vs_a_tol[tag], 'A\'\' vs A %s: %g > %g'
                % (tag, diff.max().item(), vs_a_tol[tag]))
        if tag == 'crafted':
            diag = torch.diagonal(got[0]).tolist()
            require(all(abs(x - v) <= 1e-3 * max(v, 1.0) for x, v in
                        zip(diag, (4.0, 0.0, 0.0, 100.0, 100.0, 8.0))),
                    'A\'\' crafted pairs: %s' % diag)
    nms_times = overlap_times(*sets['NMS shape'])
    print_overlap_times('NMS shape', 'G=2 M=64 N=4096', nms_times)
    log = cuda_build.BUILD_LOG['rotated_overlap_sorted']
    print("[eval V1] A'' build %.2f s (cached=%s)" % (log['seconds'],
                                                       log['cached']))

    # V2. full-width evaluation, SECOND then PointPillar, at B2 --------------
    runs = {}
    for name, cfg in cfgs.items():
        det = eval_detector(cfg, dev)
        dataset = SyntheticDataset(cfg)
        batches = list(eval_batches(dataset, 2))
        det.detect(torch.as_tensor(batches[0]['points'], device=dev),
                   torch.as_tensor(batches[0]['point_mask'], device=dev))
        result, checker, counts = run_eval_checked(det, dataset, batches, cfg)
        eval_checks(name, result, checker, counts)
        if not runs:
            require(counts.get('gather_gemm_bf16', 0) > 0,
                    'the SECOND eval launched no kernel C')
        # V3. cross-checks on V2's own batches
        cross_checks(name, checker)
        oracle_check(dev, dataset, batches, cfg)
        runs[name] = (cfg, det, dataset, counts)
        sync()

    # V4. times --------------------------------------------------------------
    name = next(iter(runs))
    cfg, det, dataset, counts = runs[name]
    for b in (2, 8):
        batches = list(eval_batches(dataset, b))
        fps, splits = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            result = eval_one_epoch(det, iter(batches), dataset, cfg)
            fps.append(len(dataset) / (time.perf_counter() - t0))
            split, grid = eval_split(det, dataset, batches, cfg)
            splits.append(split)
        med = {k: sorted(s[k] for s in splits)[1] for k in splits[0]}
        print('[eval V4 B%d] %s eval %.2f frames/s (median of %s), '
              'sec_per_example %.4f; split over %d frames (host clock, median '
              'of 3): detect %.1f ms (%.2f frames/s), recall %.1f ms, '
              'annotate %.1f ms, evaluate %.1f ms' % (
                  b, name, sorted(fps)[1], ', '.join('%.2f' % x for x in fps),
                  result['sec_per_example'], len(dataset),
                  1e3 * med['detect'], len(dataset) / med['detect'],
                  1e3 * med['recall'], 1e3 * med['annotate'],
                  1e3 * med['evaluate']))
    recall_times = overlap_times(*grid)
    print_overlap_times('B8 recall grid', 'G=8 M=%d N=%d' % (
        grid[0].shape[1], grid[1].shape[1]), recall_times)
    work = ro.sorted_work_plain(*grid)
    lengths = work['length']
    ops = a2_ops_per_pair(work).double()
    print("[eval V4] A'' accepted lists on the B8 recall grid: mean length "
          "%.4f, max %d, pairs by length %s; operations a pair (counted from "
          "the source) mean %.1f, max %d, A's %d per pair it clips" % (
              lengths.double().mean().item(), int(lengths.max()),
              torch.bincount(lengths.flatten()).tolist(), ops.mean().item(),
              int(ops.max()), A_OPS_PER_PAIR))

    # A' is launched on the main path at the G = 1 NMS shape (phase 5), so
    # its entry holds that shape's times; the recall group's are printed
    a1, a2 = nms_times["A'"], recall_times["A''"]
    return [
        kernel_entry('rotated_overlap_g1',
                     'pcdet_tpu_torch/csrc/rotated_overlap.cu',
                     'pcdet_tpu/ops/pallas/rotated_overlap.py:252',
                     g1_launches, max(a1['err'], recall_times["A'"]['err']),
                     a1['ms'], a1['plain_ms'], a1['work']),
        kernel_entry('rotated_overlap_sorted',
                     'pcdet_tpu_torch/csrc/rotated_overlap_sorted.cu',
                     'pcdet_tpu/ops/pallas/rotated_overlap.py:320',
                     counts['rotated_overlap_sorted'], max(v1_err, a2['err']),
                     a2['ms'], a2['plain_ms'], a2['work'])]


# ----------------------------------------------------------------------------
# P1-P4: PointPillar training, checkpoints and the evaluation of one
# ----------------------------------------------------------------------------

def pp_host_stages(trainer, points, mask, gt, iters=5):
    """Median ms of PointPillar's make_batch stages, each on its own:
    voxelize (CUDA events), targets (host assign), upload of the targets
    (host clock, synchronised)."""
    from pcdet_tpu_torch.ops import host_books
    t = {'voxelize': [], 'targets': [], 'h2d': []}
    for _ in range(iters):
        sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        trainer.voxelize(points, mask)
        e1.record()
        sync()
        t['voxelize'].append(e0.elapsed_time(e1))
        t0 = time.perf_counter()
        labels, reg = trainer.targets(gt)
        t1 = time.perf_counter()
        host_books.upload([('box_cls_labels', labels),
                           ('box_reg_targets', reg)], trainer.device)
        sync()
        t2 = time.perf_counter()
        t['targets'].append(1e3 * (t1 - t0))
        t['h2d'].append(1e3 * (t2 - t1))
    return ({k: sorted(v)[len(v) // 2] for k, v in t.items()},
            labels.nbytes + reg.nbytes)


def grad_groups(names):
    """Parameter name -> its module group for the per-module errors:
    'vfe', 'rpn_head.blocks.<i>', 'rpn_head.deblocks.<i>', 'rpn_head.conv_*'."""
    out = {}
    for n in names:
        parts = n.split('.')
        out[n] = '.'.join(parts[:3] if parts[1] in ('blocks', 'deblocks')
                          else parts[:2] if parts[0] == 'rpn_head'
                          else parts[:1])
    return out


def state_tensors(trainer):
    """Every tensor of a trainer's state by name, and (step, count)."""
    sd = trainer.state.state_dict()
    out = {'model.' + k: v for k, v in sd['model_state'].items()}
    for slot, d in sd['optimizer_state']['state'].items():
        out.update({'opt.%s.%s' % (slot, k): v for k, v in d.items()})
    return out, (sd['it'], sd['optimizer_state']['count'])


def step_four_ways(tag, what, cfg, dev, total, make):
    """One PointPillar train step from the same seeded weights, GPU (G) and
    CPU (C), each in f32 (TF32 off) and f64; `make(trainer, device, dtype)`
    gives the batch.  Prints the losses and, per module, the largest
    gradient error over max |grad|; requires the f32 losses within 1e-4
    relative, the f64 loss and every f64 gradient within 1e-9.  Returns
    {'G32' / 'C32' / 'G64' / 'C64': (loss, {name: grad on the CPU in f64},
    the batch's coordinates on the CPU)}."""
    from pcdet_tpu_torch.train import train_state
    from pcdet_tpu_torch.train.trainer import build_trainer

    out = {}
    for name, d, dtype in (('G32', dev, torch.float32),
                           ('C32', torch.device('cpu'), torch.float32),
                           ('G64', dev, torch.float64),
                           ('C64', torch.device('cpu'), torch.float64)):
        tr = build_trainer(cfg, d, seed=0, total_steps=total)
        tr.model.module.to(dtype)
        t0 = time.perf_counter()
        b = make(tr, d, dtype)
        loss, _, grads = train_state.loss_and_grads(tr.model, tr.state.params,
                                                    b)
        names = [n for n, _ in tr.model.module.named_parameters()]
        out[name] = (float(loss), {n: g.cpu().double()
                                   for n, g in zip(names, grads)},
                     b['coordinates'].cpu())
        print('%s %s train step %s: %.2f s' % (
            tag, name, what, time.perf_counter() - t0))
        del tr, b, grads
    rel32 = abs(out['G32'][0] - out['C32'][0]) / abs(out['C32'][0])
    rel64 = abs(out['G64'][0] - out['C64'][0]) / abs(out['C64'][0])
    print('%s loss G32 %.7f, C32 %.7f (rel %.3g); G64 %.12f, C64 %.12f (rel '
          '%.3g)' % (tag, out['G32'][0], out['C32'][0], rel32,
                     out['G64'][0], out['C64'][0], rel64))
    groups = grad_groups(out['C64'][1])
    worst64 = 0.0
    for a, b in (('G32', 'C32'), ('G32', 'C64'), ('C32', 'C64'),
                 ('G64', 'C64')):
        per = {}
        for n, ref in out['C64'][1].items():
            e = ((out[a][1][n] - out[b][1][n]).abs().max().item()
                 / ref.abs().max().item())
            per[groups[n]] = max(per.get(groups[n], 0.0), e)
        if a == 'G64':
            worst64 = max(per.values())
        print('%s gradient %s vs %s, largest error / max |grad| per module: '
              '%s' % (tag, a, b, ', '.join('%s %.2e' % x
                                           for x in per.items())))
    require(rel32 <= 1e-4, '%s GPU vs CPU f32 loss %g relative'
            % (tag, rel32))
    require(rel64 <= 1e-9 and worst64 <= 1e-9, '%s GPU vs CPU f64: loss %g '
            'relative, gradients %g of max' % (tag, rel64, worst64))
    return out


def run_pointpillar_train(dev, cfg, steps=5):
    """Phases P1-P4 on PointPillar training; returns kernel A's launches in
    P4's evaluation of the trained checkpoint."""
    import tempfile

    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.datasets.synthetic import (SyntheticDataset,
                                                    eval_batches)
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    from pcdet_tpu_torch.train import checkpoint
    from pcdet_tpu_torch.train.eval_loop import eval_one_epoch
    from pcdet_tpu_torch.train.train_loop import train_model
    from pcdet_tpu_torch.train.trainer import (TrainScans, build_trainer,
                                               make_train_scans)

    # P1. full-width training at B2, 5 steps on one batch --------------------
    total = 50
    trainer = build_trainer(cfg, dev, seed=0, total_steps=total)
    pts_np, mask_np, gt_np = make_train_scans(cfg, 8)
    pts_all = torch.as_tensor(pts_np, device=dev)
    mask_all = torch.as_tensor(mask_np, device=dev)
    pts2, mask2 = pts_all[:2].contiguous(), mask_all[:2].contiguous()
    batch2 = trainer.make_batch(pts2, mask2, gt_np[:2])
    tbs = []
    t0 = time.perf_counter()
    for _ in range(steps):
        tbs.append({k: v.item() for k, v in trainer.step(batch2).items()})
    sync()
    wall = time.perf_counter() - t0
    losses = [tb['loss'] for tb in tbs]
    print('[pp train P1] pointpillar.yaml B2, %d steps on one batch in %.2f '
          's: loss %s; last tb %s; voxels %s of cap %d; anchors %d, positive '
          '%s' % (steps, wall, ', '.join('%.5f' % x for x in losses),
                  {k: round(v, 5) for k, v in tbs[-1].items()
                   if not k.startswith('overflow')},
                  batch2['voxel_mask'].sum(1).tolist(), trainer.max_voxels,
                  trainer.model.anchors.shape[0],
                  (batch2['box_cls_labels'] > 0).sum(1).tolist()))
    print('[pp train P1] overflow/voxelizer per step: %s (per sample %s)' % (
        [tb['overflow/voxelizer'] for tb in tbs],
        batch2['voxel_overflow'].tolist()))
    require(all(np.isfinite(v) for tb in tbs for v in tb.values()),
            'PointPillar training: a non-finite loss term')
    require(losses[-1] < losses[0], 'PointPillar loss did not fall in %d '
            'steps: %s' % (steps, losses))

    # P2. one B1 step: GPU vs CPU in f32 (TF32 off) and f64 ------------------
    def make_b1(tr, d, dtype):
        b1 = tr.make_batch(pts_all[:1].to(d), mask_all[:1].to(d), gt_np[:1])
        for key in ('voxels', 'box_reg_targets'):
            b1[key] = b1[key].to(dtype)
        return b1
    out = step_four_ways('[pp train P2]', 'B1 (forward + loss + backward, '
                         'batch built)', cfg, dev, total, make_b1)
    require(torch.equal(out['G32'][2], out['C32'][2]),
            'GPU and CPU pillar coords differ')

    # P3. timings at B2 and B8 ------------------------------------------------
    for b in (2, 8):
        pts, mask = pts_all[:b].contiguous(), mask_all[:b].contiguous()
        gt = gt_np[:b]
        batch = trainer.make_batch(pts, mask, gt)
        trainer.step(batch)                                  # warm-up
        sync()
        full, pre = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer.step(trainer.make_batch(pts, mask, gt))
            sync()
            full.append(1e3 * (time.perf_counter() - t0) / steps)
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer.step(batch)
            sync()
            pre.append(1e3 * (time.perf_counter() - t0) / steps)
        ms_full, ms_pre = sorted(full)[1], sorted(pre)[1]
        host, nbytes = pp_host_stages(trainer, pts, mask, gt)
        dev_split = train_step_split(trainer, batch)
        print('[pp train P3 B%d] step with the batch built: %.2f ms (%.2f '
              'samples/s; ms per step %s); prebuilt batch: %.2f ms (%.2f '
              'samples/s, %.2f ms per sample; %s); median of 3 runs of %d '
              'steps' % (b, ms_full, 1e3 * b / ms_full,
                         ', '.join('%.2f' % x for x in full), ms_pre,
                         1e3 * b / ms_pre, ms_pre / b,
                         ', '.join('%.2f' % x for x in pre), steps))
        print('[pp train P3 B%d] voxelize %.2f ms; targets (host assign) '
              '%.2f ms (%.2f per sample, %d anchors); upload of the targets '
              '%.2f ms (%.2f MB, %.2f MB per sample); forward + loss %.2f ms, '
              'backward %.2f ms, optimizer %.2f ms' % (
                  b, host['voxelize'], host['targets'], host['targets'] / b,
                  trainer.model.anchors.shape[0], host['h2d'], nbytes / 1e6,
                  nbytes / 1e6 / b, dev_split['forward'],
                  dev_split['backward'], dev_split['optimizer']))
        busy, rows = profile_train(trainer, batch)
        if not rows:
            print('[pp train P3 B%d] no device time recorded: not measured'
                  % b)
            continue
        idle = ('idle %.1f%% of the prebuilt step, %.1f%% of the step with '
                'the batch built' % (100 * (1 - busy / ms_pre),
                                     100 * (1 - busy / ms_full))
                if busy <= ms_pre else 'idle not measured (busy under the '
                'profiler exceeds the unprofiled prebuilt step)')
        print('[pp train P3 B%d] device busy %.2f ms per step: %s; %d kernel '
              'names' % (b, busy, idle, len(rows)))
        for tt, name in rows[:12]:
            print('[pp train P3 B%d]   kernel %7.3f ms %5.1f%%  %s' % (
                b, tt, 100 * tt / busy, name[:90]))
    del trainer, batch, batch2
    sync()

    # P4. two epochs through train_model, a checkpoint, its evaluation -------
    scans = TrainScans(cfg, 4, 2)
    trainer = build_trainer(cfg, dev, seed=0, iters_each_epoch=len(scans),
                            epochs=2)
    with torch.no_grad():       # the focal prior keeps every score under
        trainer.model.module.rpn_head.conv_cls.bias.zero_()   # SCORE_THRESH
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train_model(trainer, scans, 2, ckpt_save_dir=tmp)
        sync()
        wall = time.perf_counter() - t0
        ckpts = [p.rsplit('/', 1)[-1] for p in checkpoint.list_checkpoints(tmp)]
        path = checkpoint.latest_checkpoint(tmp)
        require(ckpts == ['checkpoint_epoch_1.pth', 'checkpoint_epoch_2.pth']
                and path.endswith('checkpoint_epoch_2.pth'),
                'checkpoints %s, latest %s' % (ckpts, path))
        restored = build_trainer(cfg, dev, seed=1,
                                 iters_each_epoch=len(scans), epochs=2)
        _, epoch = checkpoint.restore_train_state(path, restored.state)
        live, counts = state_tensors(trainer)
        back, back_counts = state_tensors(restored)
        differ = [k for k in live if not torch.equal(live[k], back[k])]
        print('[pp train P4] train_model 2 epochs of %d batches (B2) in %.2f '
              's, step %d; checkpoints %s; restored epoch %d, (step, count) '
              '%s; %d tensors, %d differ from the live state' % (
                  len(scans), wall, trainer.state.step, ckpts, epoch,
                  back_counts, len(live), len(differ)))
        require(epoch == 2 and counts == back_counts == (4, 4)
                and sorted(live) == sorted(back) and not differ,
                'restored state differs from the live one: %s' % differ[:5])
        det = detect_mod.build_detector(cfg, dev, seed=1, checkpoint=path)
    eval_cfg = copy.deepcopy(cfg)
    eval_cfg.DATA_CONFIG.SYNTHETIC = dict(EVAL_SYNTHETIC)
    dataset = SyntheticDataset(eval_cfg)
    batches = list(eval_batches(dataset, 2))
    ro.LAUNCHES = 0
    result = eval_one_epoch(det, iter(batches), dataset, eval_cfg)
    sync()
    a_launches = ro.LAUNCHES
    print('[pp train P4] eval of the checkpoint, %d frames at B2: '
          'recall/gt %s, recall/rcnn_0.5 %s, Car_3d_moderate %s, '
          'overflow/voxelizer %s, sec_per_example %.4f; kernel A launches %d'
          % (len(dataset), result['recall/gt'], result['recall/rcnn_0.5'],
             result.get('Car_3d_moderate'), result.get('overflow/voxelizer'),
             result['sec_per_example'], a_launches))
    require(a_launches > 0, 'the checkpoint\'s evaluation launched no '
            'kernel A')
    require(all(np.isfinite(float(v)) for v in result.values()),
            'the checkpoint\'s evaluation: a result is not finite')
    # the restored detector against the trained module's own eval detect
    trainer.model.eval_mode()
    worst, nums = 0.0, []
    for batch in batches[:2]:
        pts = torch.as_tensor(batch['points'], device=dev)
        mask = torch.as_tensor(batch['point_mask'], device=dev)
        got = det.detect(pts, mask)
        with torch.inference_mode():
            want = trainer.model.predict(
                trainer.model.forward(det.voxelize(pts, mask)))
        require(torch.equal(got['num'], want['num'])
                and torch.equal(got['valid'], want['valid']),
                'restored detections %s, trained module %s'
                % (got['num'].tolist(), want['num'].tolist()))
        worst = max(worst, (got['boxes'] - want['boxes']).abs().max().item())
        nums += got['num'].tolist()
    print('[pp train P4] restored detector vs the trained module\'s eval '
          'detect on 4 frames: num %s equal, max |box diff| %.3g' % (
              nums, worst))
    require(worst <= 1e-5 and sum(nums) > 0, 'restored detector: boxes '
            'differ by %g, num %s' % (worst, nums))
    del trainer, restored, det
    sync()
    return a_launches


# ----------------------------------------------------------------------------
# L1-L4: the data pipeline and the CLI pair on a KITTI-format tree
# ----------------------------------------------------------------------------

# tests/test_kitti_dataset.py's calibration: the camera at the lidar origin,
# x_cam = -y_l, y_cam = -z_l, z_cam = x_l
KITTI_V2C = np.array([[0., -1., 0., 0.], [0., 0., -1., 0.],
                      [1., 0., 0., 0.]], np.float32)
KITTI_P2 = np.array([[700., 0., 600., 0.], [0., 700., 180., 0.],
                     [0., 0., 1., 0.]], np.float32)
IMAGE_W, IMAGE_H = 1242, 375
KITTI_CLASSES = ['Car', 'Pedestrian', 'Cyclist']


def png_bytes(width, height):
    """A black RGB PNG, written with zlib and struct only."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))
    raw = (b'\x00' + bytes(3 * width)) * height
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8, 2, 0,
                                         0, 0))
            + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))


def write_kitti_frame(root, sid, seed, png):
    """One frame of a KITTI tree: a bench-density ring scan (24 objects to
    68 m, ~65k points) as velodyne, the labels of the objects whose 2D box
    centre lies in the image (camera frame), calib, road plane, image.
    Returns the number of labelled objects."""
    import os

    from pcdet_tpu_torch.datasets.synthetic import make_scene
    from pcdet_tpu_torch.utils import box_np_ops
    from pcdet_tpu_torch.utils.calibration import Calibration
    pts, boxes, names = make_scene(
        np.random.RandomState(seed), KITTI_CLASSES, num_objects=24,
        ground_mode='rings', pts_per_obj=400, x_range=(3, 68),
        y_range=(-38, 38))
    split = os.path.join(root, 'training')
    pts.astype(np.float32).tofile(os.path.join(split, 'velodyne',
                                               sid + '.bin'))
    with open(os.path.join(split, 'image_2', sid + '.png'), 'wb') as f:
        f.write(png)
    mat = lambda name, m: '%s: %s' % (name, ' '.join('%.6f' % v
                                                     for v in m.ravel()))
    with open(os.path.join(split, 'calib', sid + '.txt'), 'w') as f:
        f.write('\n'.join([
            mat('P0', np.zeros(12)), mat('P1', np.zeros(12)),
            mat('P2', KITTI_P2), mat('P3', KITTI_P2),
            mat('R0_rect', np.eye(3)), mat('Tr_velo_to_cam', KITTI_V2C),
            mat('Tr_imu_to_velo', np.zeros(12))]) + '\n')
    with open(os.path.join(split, 'planes', sid + '.txt'), 'w') as f:
        f.write('# Plane\nWidth 4\nHeight 1\n0 -1 0 1.73\n')
    calib = Calibration({'P2': KITTI_P2, 'R0': np.eye(3, dtype=np.float32),
                         'Tr_velo2cam': KITTI_V2C})
    cam = box_np_ops.boxes3d_lidar_to_camera(boxes, calib)
    img = box_np_ops.boxes3d_camera_to_imageboxes(cam, calib)
    cu, cv = (img[:, 0] + img[:, 2]) / 2, (img[:, 1] + img[:, 3]) / 2
    keep = (cam[:, 2] > 1) & (cu >= 0) & (cu < IMAGE_W) & (cv >= 0) & (
        cv < IMAGE_H)
    lines = []
    for b, c, name in zip(img[keep], cam[keep], names[keep]):
        b = np.clip(b, 0, [IMAGE_W - 1, IMAGE_H - 1] * 2)
        alpha = -np.arctan2(-c[0], c[2]) + c[6]
        lines.append('%s 0.00 0 %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f '
                     '%.2f %.2f %.2f %.2f' % (name, alpha, *b, c[4], c[5],
                                              c[3], *c[:3], c[6]))
    with open(os.path.join(split, 'label_2', sid + '.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return len(lines)


def write_kitti_tree(root, n_train, n_val):
    """A KITTI-format tree of n_train + n_val frames (ImageSets train / val)."""
    import os
    for sub in ('velodyne', 'image_2', 'calib', 'label_2', 'planes'):
        os.makedirs(os.path.join(root, 'training', sub), exist_ok=True)
    os.makedirs(os.path.join(root, 'ImageSets'), exist_ok=True)
    ids = ['%06d' % i for i in range(n_train + n_val)]
    for name, part in (('train', ids[:n_train]), ('val', ids[n_train:])):
        with open(os.path.join(root, 'ImageSets', name + '.txt'), 'w') as f:
            f.write('\n'.join(part) + '\n')
    png = png_bytes(IMAGE_W, IMAGE_H)
    return [write_kitti_frame(root, sid, 100 + i, png)
            for i, sid in enumerate(ids)]


def cli_sets(root, out_root, train_info='kitti_infos_train.pkl',
             val_info='kitti_infos_val.pkl'):
    """The CLIs' `--set` pairs that point a shipped config at the tree."""
    import os
    return ['ROOT_DIR', out_root, 'DATA_CONFIG.DATA_DIR', root,
            'DATA_CONFIG.TRAIN.INFO_PATH', os.path.join(root, train_info),
            'DATA_CONFIG.TEST.INFO_PATH', os.path.join(root, val_info),
            'DATA_CONFIG.AUGMENTATION.DB_SAMPLER.DB_INFO_PATH',
            os.path.join(root, 'kitti_dbinfos_train.pkl')]


def log_records(log_file, pattern):
    """The values of `pattern`'s first group in a CLI log, in order."""
    with open(log_file) as f:
        return re.findall(pattern, f.read())


def logged_result(log_file):
    """The AP string of the last evaluation a test CLI log holds."""
    with open(log_file) as f:
        lines = f.read().splitlines()
    stamp = re.compile(r'^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d+ ')
    starts = [i for i, line in enumerate(lines)
              if stamp.match(line) and 'INFO  Car AP@' in line]
    require(starts, 'no AP string in %s' % log_file)
    out = [lines[starts[-1]].split('INFO  ', 1)[1]]
    for line in lines[starts[-1] + 1:]:
        if stamp.match(line):
            break
        out.append(line)
    return '\n'.join(out).strip()


def finite_numbers(text):
    nums = re.findall(r'-?\d+\.\d+|nan|inf', text)
    return bool(nums) and all(np.isfinite(float(x)) for x in nums)


def loader_epochs(trainer, cfg, b, workers, epochs, warm_up=True,
                  profile=False):
    """Train steps fed by the loader (`build_dataloader`, thread workers, 0:
    none, the batches made in the loop) for `epochs` epochs, after one of
    warm-up if `warm_up`.  Each epoch's first step, which waits for a new
    worker pool and an empty prefetch queue, is timed apart from the steady
    steps after it.  Returns, in ms, host clock: per steady step in all
    ('steady') and split into the wait on the loader, `upload` (a pageable
    copy, which also waits for the card's previous step) and `step` (its
    launches); per first step ('first') and its wait; per step over
    everything ('ms'); with workers, the loader's ms per batch with no step
    taken, steady and first (None without: the loop's wait is that); the
    steps and steady steps; and the device's busy ms per step under
    torch.profiler (or None)."""
    from pcdet_tpu_torch.datasets import build_dataloader
    ds, loader = build_dataloader(cfg, b, training=True, num_workers=workers)
    ds.set_anchor_targets(trainer.model.anchor_targets)

    def run(epoch, train=True):
        loader.set_epoch(epoch)
        sync()
        t0 = time.perf_counter()
        first, parts, n = None, [0.0, 0.0, 0.0], 0
        it = iter(loader)
        while True:
            t1 = time.perf_counter()
            item = next(it, None)
            t2 = time.perf_counter()
            if item is None:
                break
            t3 = t4 = t2
            if train:
                batch = trainer.upload(item)
                t3 = time.perf_counter()
                trainer.step(batch)
                t4 = time.perf_counter()
            if n == 0:
                first = (t4 - t0, t2 - t0)
            else:
                parts[0] += t2 - t1
                parts[1] += t3 - t2
                parts[2] += t4 - t3
            n += 1
        sync()
        wall = time.perf_counter() - t0
        return [wall, wall - first[0], first[0], first[1]] + parts + [n]
    if warm_up:
        run(0)
    wall, rest, first, first_wait, wait, upload, step, n = (
        sum(x) for x in zip(*[run(e) for e in range(1, 1 + epochs)]))
    alone = run(1 + epochs, train=False) if workers else None
    busy = None
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            pn = run(2 + epochs)[-1]
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and e.device_type == DeviceType.CUDA) / 1e3 / pn
    steady = n - epochs
    per = lambda x: 1e3 * x / steady
    return {'ms': 1e3 * wall / n, 'steady': per(rest), 'wait': per(wait),
            'upload': per(upload), 'step': per(step),
            'first': 1e3 * first / epochs,
            'first_wait': 1e3 * first_wait / epochs, 'steps': n,
            'steady_steps': steady,
            'alone': alone and 1e3 * alone[1] / (alone[-1] - 1),
            'alone_first': alone and 1e3 * alone[2], 'busy': busy}


def first_epoch(cfg, anchor_targets, workers, mode):
    """Every batch of epoch 0 of the training loader."""
    from pcdet_tpu_torch.datasets import build_dataloader
    ds, loader = build_dataloader(cfg, 2, training=True, num_workers=workers,
                                  worker_mode=mode)
    ds.set_anchor_targets(anchor_targets)
    loader.set_epoch(0)
    return list(loader)


def batches_equal(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if sorted(x) != sorted(y):
            return False
        for k in x:
            u, v = x[k], y[k]
            if isinstance(u, np.ndarray):
                if u.dtype != v.dtype or not np.array_equal(u, v):
                    return False
            elif list(np.ravel(u)) != list(np.ravel(v)):
                return False
    return True


def run_cli(dev):
    """Phases L1-L4; returns the launches of the CLI paths by kernel entry
    name: {name: {'cli_train' / 'cli_eval': n}}."""
    import os
    import pickle
    import tempfile

    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.datasets import build_dataloader
    from pcdet_tpu_torch.datasets.kitti import kitti_eval_cli
    from pcdet_tpu_torch.datasets.kitti.kitti_eval import eval as kitti_eval
    from pcdet_tpu_torch.ops import host_books, sparse
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    from pcdet_tpu_torch.tools import test as test_cli
    from pcdet_tpu_torch.tools import train as train_cli
    from pcdet_tpu_torch.train.trainer import build_trainer

    here = os.path.dirname(os.path.abspath(__file__))
    pp_cfg = str(detect_mod.DEFAULT_CFG)
    second_cfg = str(detect_mod.SECOND_CFG)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, out_root = os.path.join(tmp, 'kitti'), os.path.join(tmp, 'out')

        # L1. a KITTI-format tree, then create_data ---------------------------
        t0 = time.perf_counter()
        labelled = write_kitti_tree(root, 16, 8)
        t_tree = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'pcdet_tpu_torch.tools.create_data',
             'kitti', '--cfg_file', pp_cfg, '--data_path', root,
             '--workers', '4'], cwd=here, capture_output=True, text=True,
            timeout=600)
        t_create = time.perf_counter() - t0
        require(proc.returncode == 0, 'create_data failed:\n%s'
                % proc.stderr[-3000:])
        infos = {}
        for split in ('train', 'val', 'trainval'):
            with open(os.path.join(root, 'kitti_infos_%s.pkl' % split),
                      'rb') as f:
                infos[split] = pickle.load(f)
        with open(os.path.join(root, 'kitti_dbinfos_train.pkl'), 'rb') as f:
            db = pickle.load(f)
        n_pts = [os.path.getsize(os.path.join(
            root, 'training', 'velodyne', '%06d.bin' % i)) // 16
            for i in range(24)]
        print('[cli L1] KITTI tree of 16 train + 8 val frames written in '
              '%.2f s (%d-%d points, %d-%d labelled objects a frame); '
              'create_data in %.2f s: infos train %d, val %d, trainval %d; '
              'GT database %s' % (
                  t_tree, min(n_pts), max(n_pts), min(labelled),
                  max(labelled), t_create, len(infos['train']),
                  len(infos['val']), len(infos['trainval']),
                  {str(k): len(v) for k, v in db.items()}))
        require(len(infos['train']) == 16 and len(infos['val']) == 8
                and len(infos['trainval']) == 24 and db.get('Car'),
                'create_data: infos %s, database %s' % (
                    {k: len(v) for k, v in infos.items()}, list(db)))

        # L2. the train CLI, pointpillar.yaml full width, B2, 2 epochs --------
        sets = cli_sets(root, out_root)
        argv = ['--cfg_file', pp_cfg, '--batch_size', '2', '--epochs', '2',
                '--workers', '4', '--worker_mode', 'thread',
                '--ckpt_save_interval', '1', '--log_interval', '1',
                '--extra_tag', 'chip_smoke', '--device', dev.type, '--set'] + sets
        t0 = time.perf_counter()
        out = train_cli.main(argv)
        sync()
        t_train = time.perf_counter() - t0
        cfg = train_cli.parse_config(argv)[1]
        losses = [float(x) for x in log_records(
            out['log_file'], r'iter \d+ loss (\S+) ')]
        overflow = [int(x) for x in log_records(
            out['log_file'], r'overflow/voxelizer (\d+)')]
        ckpt_dir = str(out['ckpt_dir'])
        ckpts = sorted(os.listdir(ckpt_dir))
        print('[cli L2] train CLI pointpillar.yaml B2, 2 epochs of %d steps '
              '(4 thread workers) in %.2f s: loss %s; overflow/voxelizer per '
              'logged step %s; checkpoints %s' % (
                  len(losses) // 2, t_train, ', '.join(
                      '%.4f' % x for x in losses), overflow, ckpts))
        require(len(losses) == 16 and all(np.isfinite(losses)),
                'train CLI losses: %s' % losses)
        require(np.mean(losses[-4:]) < np.mean(losses[:4]),
                'train CLI: the loss did not fall (first 4 %s, last 4 %s)'
                % (losses[:4], losses[-4:]))
        require(len(overflow) == len(losses), 'overflow/voxelizer is not '
                'in every logged step')
        require(ckpts == ['checkpoint_epoch_1.pth', 'checkpoint_epoch_2.pth'],
                'checkpoints %s' % ckpts)
        targets = out['trainer'].model.anchor_targets
        del out
        # the loader's batches: thread 4 == process 4 == thread 0 workers;
        # the process pool forks with CUDA up in this process
        t0 = time.perf_counter()
        ref = first_epoch(cfg, targets, 4, 'thread')
        t_thread = time.perf_counter() - t0
        for workers, mode in ((4, 'process'), (0, 'thread')):
            t0 = time.perf_counter()
            same = batches_equal(first_epoch(cfg, targets, workers, mode),
                                 ref)
            print('[cli L2] loader epoch 0 (%d B2 batches) with %d %s '
                  'workers in %.2f s: bitwise equal to 4 thread workers '
                  '(%.2f s): %s' % (len(ref), workers, mode,
                                    time.perf_counter() - t0, t_thread,
                                    same))
            require(same, 'loader batches differ under %d %s workers'
                    % (workers, mode))
        # one step from the first batch, GPU vs CPU in f32 (TF32 off) and
        # f64, gradients included, as P2
        batch0 = ref[0]

        def make_loader_batch(tr, d, dtype):
            b = tr.upload(batch0)
            for key in ('voxels', 'box_reg_targets'):
                b[key] = b[key].to(dtype)
            return b
        step_four_ways('[cli L2]', 'B2 from the loader batch (upload, '
                       'forward, loss, backward)', cfg, dev, 16,
                       make_loader_batch)
        del ref, batch0
        # ms per step with the loader's prefetch (4 thread workers) and
        # without (0 workers), B2 and B8, on a tree of 64 train frames, so
        # that each epoch's cold first batch is one of 32 / 8; the upload on
        # its own
        troot = os.path.join(tmp, 'kitti_timing')
        write_kitti_tree(troot, 64, 2)
        proc = subprocess.run(
            [sys.executable, '-m', 'pcdet_tpu_torch.tools.create_data',
             'kitti', '--cfg_file', pp_cfg, '--data_path', troot,
             '--workers', '4'], cwd=here, capture_output=True, text=True,
            timeout=600)
        require(proc.returncode == 0, 'create_data (timing tree) failed:\n%s'
                % proc.stderr[-3000:])
        tcfg = train_cli.parse_config(argv[:-len(sets)] + cli_sets(
            troot, out_root))[1]
        trainer = build_trainer(tcfg, dev, seed=0, total_steps=1000)
        for b, epochs in ((2, 1), (8, 2)):
            for w in (4, 0):
                t = loader_epochs(trainer, tcfg, b, w, epochs,
                                  warm_up=(w == 4), profile=True)
                idle = ('busy %.2f ms a step, idle %.1f%% of a steady step, '
                        '%.1f%% of all' % (
                            t['busy'], 100 * (1 - t['busy'] / t['steady']),
                            100 * (1 - t['busy'] / t['ms']))
                        if t['busy'] else 'idle not measured')
                alone = ('the loader alone %.2f ms a steady batch, %.2f its '
                         'first; ' % (t['alone'], t['alone_first'])
                         if t['alone'] else '')
                print('[cli L2 B%d] loader with %d workers, 64 train frames: '
                      'steady %.2f ms per step (%.2f samples/s; %d steps '
                      'over %d epochs); per steady step, host clock: waiting '
                      'on the loader %.2f ms, in upload %.2f ms, in step '
                      '%.2f ms; each epoch\'s first step %.2f ms (waiting '
                      '%.2f); all steps %.2f ms (%.2f samples/s); %sdevice '
                      '%s' % (
                          b, w, t['steady'], 1e3 * b / t['steady'],
                          t['steady_steps'], epochs, t['wait'], t['upload'],
                          t['step'], t['first'], t['first_wait'], t['ms'],
                          1e3 * b / t['ms'], alone, idle))
            ds, loader = build_dataloader(tcfg, b, training=True,
                                          num_workers=4)
            ds.set_anchor_targets(trainer.model.anchor_targets)
            loader.set_epoch(0)
            batch = next(iter(loader))
            nbytes = sum(v.nbytes for k, v in batch.items()
                         if k in host_books.LOADER_KEYS
                         and isinstance(v, np.ndarray))
            up = []
            for _ in range(5):
                sync()
                t0 = time.perf_counter()
                trainer.upload(batch)
                sync()
                up.append(1e3 * (time.perf_counter() - t0))
            print('[cli L2 B%d] upload of a loader batch (one pageable '
                  'copy): %.2f ms (median of 5), %.2f MB' % (
                      b, sorted(up)[2], nbytes / 1e6))
            del batch, loader, ds
        del trainer
        sync()

        # L3. the test CLI on the last checkpoint, 8 val frames at B2 --------
        eval_sets = sets + ['MODEL.TEST.SCORE_THRESH', '0.0']
        targv = ['--cfg_file', pp_cfg, '--batch_size', '2', '--workers', '4',
                 '--extra_tag', 'chip_smoke', '--device', dev.type, '--ckpt',
                 os.path.join(ckpt_dir, 'checkpoint_epoch_2.pth'),
                 '--set'] + eval_sets
        ro.LAUNCHES = 0
        t0 = time.perf_counter()
        tout = test_cli.main(targv)
        sync()
        a_launches = ro.LAUNCHES
        eval_dir, result = tout['results'][2]
        with open(os.path.join(str(eval_dir), 'result.pkl'), 'rb') as f:
            det_annos = pickle.load(f)
        again, _ = kitti_eval_cli.evaluation(det_annos, infos['val'],
                                             KITTI_CLASSES)
        logged = logged_result(tout['log_file'])
        coco = kitti_eval.get_coco_eval_result(
            [copy.deepcopy(i['annos']) for i in infos['val']],
            copy.deepcopy(det_annos), KITTI_CLASSES)
        print('[cli L3] test CLI on checkpoint_epoch_2, %d val frames at B2 '
              'in %.2f s: kernel A launches %d; recall/gt %s, rcnn_0.5 %s, '
              'rcnn_0.7 %s; %d detections; Car_3d_moderate %s; '
              'sec_per_example %.4f; logged AP string == the evaluator on '
              'result.pkl: %s' % (
                  len(det_annos), time.perf_counter() - t0, a_launches,
                  result['recall/gt'], result['recall/rcnn_0.5'],
                  result['recall/rcnn_0.7'],
                  sum(a['num_example'] for a in det_annos),
                  result.get('Car_3d_moderate'), result['sec_per_example'],
                  logged == again.strip()))
        print('[cli L3] COCO string: %s' % ' | '.join(coco.splitlines()[:4]))
        require(a_launches > 0, 'the test CLI launched no kernel A')
        require(len(det_annos) == 8 and result['recall/gt'] > 0,
                'test CLI: %d annos, recall/gt %s' % (len(det_annos),
                                                      result['recall/gt']))
        require(all(np.isfinite(float(result[k])) for k in result
                    if k.startswith('recall/')), 'recall not finite')
        require(finite_numbers(logged) and finite_numbers(coco),
                'the AP or COCO string holds a non-finite number')
        require(logged == again.strip(), 'the logged AP string differs from '
                'the evaluator run again on result.pkl')
        paths['rotated_overlap'] = {'cli_eval': a_launches}
        # --eval_all over L2's directory
        t0 = time.perf_counter()
        aout = test_cli.main(['--cfg_file', pp_cfg, '--batch_size', '2',
                              '--workers', '4', '--extra_tag', 'chip_smoke', '--device', dev.type,
                              '--eval_all', '--max_waiting_mins', '0',
                              '--set'] + eval_sets)
        record = os.path.join(str(aout['eval_root']), 'eval_list_val.txt')
        with open(record) as f:
            listed = f.read().split()
        print('[cli L3] --eval_all --max_waiting_mins 0 in %.2f s: evaluated '
              'epochs %s, eval_list_val.txt %s' % (
                  time.perf_counter() - t0, sorted(aout['results']), listed))
        require(sorted(aout['results']) == [1, 2] and listed == ['1', '2'],
                '--eval_all evaluated %s, listed %s' % (
                    sorted(aout['results']), listed))
        del tout, aout
        sync()

        # L4. SECOND through the same pair: 2 B2 steps, 4 val frames ---------
        for split, n in (('train', 4), ('val', 4)):
            with open(os.path.join(root, 'kitti_infos_%s4.pkl' % split),
                      'wb') as f:
                pickle.dump(infos[split][:n], f)
        s_sets = cli_sets(root, out_root, 'kitti_infos_train4.pkl',
                          'kitti_infos_val4.pkl')
        clamped = []
        real_selectors = sparse.xwin_selectors

        def selectors(*args, **kw):
            out = real_selectors(*args, **kw)
            clamped.append(out[2])
            return out
        sparse.xwin_selectors = selectors
        try:
            reset_launches()
            t0 = time.perf_counter()
            sout = train_cli.main(
                ['--cfg_file', second_cfg, '--batch_size', '2', '--epochs',
                 '1', '--workers', '4', '--ckpt_save_interval', '1',
                 '--log_interval', '1', '--extra_tag', 'chip_smoke', '--device', dev.type,
                 '--set'] + s_sets)
            sync()
            train_counts = nonzero(all_launches())
        finally:
            sparse.xwin_selectors = real_selectors
        misses = sum(int(c) for c in clamped)
        s_losses = [float(x) for x in log_records(
            sout['log_file'], r'iter \d+ loss (\S+) ')]
        s_overflow = log_records(sout['log_file'],
                                 r'loss \S+ lr \S+ (overflow/.*)')
        print('[cli L4] train CLI second.yaml B2, 1 epoch of %d steps in '
              '%.2f s: loss %s; %s; launches %s; selector builds %d, taps '
              'outside their window %d' % (
                  len(s_losses), time.perf_counter() - t0, s_losses,
                  s_overflow, train_counts, len(clamped), misses))
        require(len(s_losses) == 2 and all(np.isfinite(s_losses)),
                'SECOND train CLI losses %s' % s_losses)
        for key in ('gather_gemm_f32', 'gather_gemm_f32_dgrad', 'gather_dw',
                    'gather_dw_seg'):
            require(train_counts.get(key, 0) > 0, 'SECOND train CLI: no '
                    'launch of %s' % key)
        require(clamped and misses == 0, 'SECOND train CLI: %d selector '
                'builds, %d taps outside their window' % (len(clamped),
                                                          misses))
        del sout
        reset_launches()
        ro.LAUNCHES = 0
        t0 = time.perf_counter()
        seout = test_cli.main(
            ['--cfg_file', second_cfg, '--batch_size', '2', '--workers', '4',
             '--extra_tag', 'chip_smoke', '--device', dev.type, '--ckpt', os.path.join(
                 out_root, 'output', 'second', 'chip_smoke', 'ckpt',
                 'checkpoint_epoch_1.pth'), '--set'] + s_sets
            + ['MODEL.TEST.SCORE_THRESH', '0.0'])
        sync()
        eval_counts, s_a = nonzero(all_launches()), ro.LAUNCHES
        s_result = seout['results'][1][1]
        print('[cli L4] test CLI second.yaml on its checkpoint, 4 val frames '
              'at B2 in %.2f s: launches %s, kernel A %d; recall/gt %s, '
              'rcnn_0.5 %s; Car_3d_moderate %s' % (
                  time.perf_counter() - t0, eval_counts, s_a,
                  s_result['recall/gt'], s_result['recall/rcnn_0.5'],
                  s_result.get('Car_3d_moderate')))
        require(eval_counts.get('gather_gemm_bf16', 0) > 0 and s_a > 0,
                'SECOND test CLI: launches %s, kernel A %d' % (eval_counts,
                                                                s_a))
        require(all(np.isfinite(float(v)) for v in s_result.values()),
                'SECOND test CLI: a result is not finite')
        del seout
        sync()
    paths['rotated_overlap']['cli_eval second'] = s_a
    paths['gather_gemm_f32'] = {'cli_train': train_counts['gather_gemm_f32']
                                + train_counts['gather_gemm_f32_dgrad']}
    paths['gather_dw'] = {'cli_train': train_counts['gather_dw']}
    paths['gather_dw_seg'] = {'cli_train': train_counts['gather_dw_seg']}
    paths['gather_gemm_bf16'] = {'cli_eval': eval_counts['gather_gemm_bf16']}
    return paths


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port is checked on the GPU',
              file=sys.stderr)
        return 2

    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.datasets.kitti.kitti_eval import (
        native as kitti_native)
    from pcdet_tpu_torch.ops import cuda_build, host_books, rotated_iou
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import rotated_overlap as ro

    dev = torch.device('cuda')
    # f32 stays f32: no TF32 in matmuls or convolutions (the shipped config's
    # bf16 conv stack is its own, explicit choice)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print('torch %s, CUDA %s, device %s' % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0)))

    # 1. build: every kernel (one nvcc each) and the host book builder at once
    t0 = time.perf_counter()
    builds = (ro.build, ro.build_sorted, gg.build, gd.build, gx.build,
              gd.build_xwin, kitti_native.get_lib, host_books.native_lib)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        jobs = [pool.submit(fn) for fn in builds]
        native_lib = [j.result() for j in jobs][-1]
    print('[build] all builds: %.2f s wall; native host book builder: %s'
          % (time.perf_counter() - t0, host_books._NATIVE.get('path')))
    require(native_lib is not None, 'the host book builder did not build: %s'
            % host_books.native_error())
    # the port's native books are pcdet_tpu's: the numpy builders (the
    # same algorithm as pcdet_tpu's numpy oracle) agree wherever a tap is
    # found, on a small batch of sorted coords
    rng = np.random.RandomState(0)
    shape = (9, 40, 40)
    ids = np.stack([np.sort(rng.choice(np.prod(shape), 700, replace=False))
                    for _ in range(2)])
    crd = np.stack([ids // (shape[1] * shape[2]), (ids // shape[2]) % shape[1],
                    ids % shape[2]], -1).astype(np.int32)
    crd[1, 600:] = -1
    spec = host_books.encoder_spec(shape, (768, 512, 384, 256), (1, 0, 0))
    books = [host_books.upload_books(build(crd, crd[..., 0] >= 0, shape,
                                           spec), spec, 700, 'cpu')
             for build in (host_books.build_books_batch,
                           host_books.build_books_batch_np)]
    for key, book in books[0].items():
        other = books[1][key]
        for a, b in zip(*((book, other) if isinstance(book, tuple)
                          else ((book,), (other,)))):
            require(torch.equal(a, b), 'native and numpy book %s differ' % key)
    print('[build] native host books == numpy host books on %d keys'
          % len(books[0]))
    log = cuda_build.BUILD_LOG['rotated_overlap']
    print('[build] rotated_overlap.cu: %.2f s (cached=%s)'
          % (log['seconds'], log['cached']))
    print_ptxas('rotated_overlap.cu', log)
    rows = ptxas_entries(log)
    require(not any(r[3] for r in rows), 'kernel A spills: %s' % rows)
    for lib in ('rotated_overlap_sorted', 'gather_gemm_xwin', 'gather_dw_xwin'):
        log = cuda_build.BUILD_LOG[lib]
        print('[build] %s.cu: %.2f s (cached=%s); %s' % (
            lib, log['seconds'], log['cached'], '; '.join(
                '%s<%s> %d regs, %d B spilled' % tuple(r)
                for r in ptxas_entries(log))
            or 'ptxas report empty (library reused)'))
    rows = ptxas_entries(cuda_build.BUILD_LOG['gather_dw_xwin'])
    require(not any(r[3] for r in rows), "a D'' / D' instance spills: %s"
            % rows)
    # the report is empty when the library was reused: build the source
    # again for it
    log = cuda_build.BUILD_LOG['rotated_overlap_sorted']
    rows = ptxas_entries(log) or ptxas_entries(
        {'ptxas': sorted_ptxas_report()})
    require(rows and not any(r[3] for r in rows), "kernel A'' spills or "
            "has no ptxas report: %s" % rows)
    print("[build] kernel A'': %d blocks of 128 threads an SM"
          % ro.sorted_blocks_per_sm())

    # 2. kernel A vs plain, on the card: bitwise, and its cull's count -----
    rng = np.random.RandomState(0)
    corners_b = rotated_iou.boxes5_to_corners(
        torch.as_tensor(rand_boxes5(rng, (2, 4096)), device=dev)).contiguous()
    corners_a = corners_b[:, :64].contiguous()      # includes identical pairs
    ca, cb = crafted_boxes5()
    ca = rotated_iou.boxes5_to_corners(torch.as_tensor(ca, device=dev))
    cb = rotated_iou.boxes5_to_corners(torch.as_tensor(cb, device=dev))
    grids = {'NMS shape': (corners_a, corners_b),
             'crafted': (ca[None].contiguous(), cb[None].contiguous()),
             'NMS shape with degenerate quads': degenerate_quads(corners_a,
                                                                 corners_b)}
    max_abs_err = 0.0
    for tag, (a, b) in grids.items():
        got, count = ro.pair_overlap_batched_counted(a, b)
        again = ro.pair_overlap_batched(a, b)
        want = ro.pair_overlap_batched_plain(a, b)
        kept = int(ro.overlap_maybe_nonzero_plain(a, b).sum())
        sync()
        err = (got - want).abs().max().item()
        max_abs_err = max(max_abs_err, err)
        print('[kernel] A %s %s: max |kernel - plain| %.3g, bitwise equal %s, '
              'two launches equal %s; pairs kept %d of %d (%.2f%%), plain '
              'predicate %d; %d pairs > 0' % (
                  tag, tuple(got.shape), err, torch.equal(got, want),
                  torch.equal(got, again), int(count), got.numel(),
                  100 * int(count) / got.numel(), kept, int((want > 0).sum())))
        require(torch.equal(got, want), 'kernel A %s: not bitwise equal to '
                'plain (max |diff| %g)' % (tag, err))
        require(torch.equal(got, again), 'kernel A %s: launches differ' % tag)
        require(int(count) == kept, 'kernel A %s: %d pairs kept, the plain '
                'predicate keeps %d' % (tag, int(count), kept))
        if tag == 'crafted':
            expect = {(0, 0): 4.0, (1, 1): 0.0, (2, 2): 0.0, (3, 3): 100.0,
                      (4, 4): 100.0, (5, 5): 8.0}
            for (i, j), v in expect.items():
                require(abs(got[0, i, j].item() - v) < 1e-3 * max(v, 1.0),
                        'crafted pair (%d, %d): %r, want %r' % (
                            i, j, got[0, i, j].item(), v))
    fn = (lambda: ro.pair_overlap_batched(corners_a, corners_b))
    kernel_ms, host_ms = queued_ms(fn, 100)
    launch_ms = cuda_ms(fn, 200)
    plain_ms = cuda_ms(
        lambda: ro.pair_overlap_batched_plain(corners_a, corners_b), 20)
    a_work = overlap_work(corners_a, corners_b)
    print('[kernel] A G=2 M=64 N=4096: device time %.4f ms (queued behind a '
          'spin kernel; 100 calls enqueued in %.2f ms), plain %.4f ms, bound '
          '%.4f ms (%s)' % (kernel_ms, host_ms, plain_ms, bound_ms(*a_work)[0],
                            bound_ms(*a_work)[1]))
    print('[kernel] A G=2 M=64 N=4096: a call with its launch (CUDA events '
          'around 200 calls, not queued) %.4f ms' % launch_ms)
    sync()

    # 3. full-width detect at B2 through the kernel -----------------------
    cfg = detect_mod.load_config()
    tc = cfg.MODEL.TEST
    post = int(tc.NMS_POST_MAXSIZE_LAST)
    det = detect_mod.build_detector(cfg, dev, seed=0)

    # The focal prior puts every score near sigmoid(-4.6) = 0.01, under
    # SCORE_THRESH 0.1, and NMS would run zero rounds: zero the bias.
    with torch.no_grad():
        det.model.module.rpn_head.conv_cls.bias.zero_()
    pts_np, mask_np = detect_mod.make_scans(cfg, 8)
    pts8 = torch.as_tensor(pts_np, device=dev)
    mask8 = torch.as_tensor(mask_np, device=dev)
    pts2, mask2 = pts8[:2].contiguous(), mask8[:2].contiguous()
    det.detect(pts2, mask2)                    # warm-up (cuDNN algorithms)
    sync()
    ro.LAUNCHES = 0
    preds = det.detect(pts2, mask2)
    sync()
    launches_b2 = ro.LAUNCHES
    num = preds['num'].tolist()
    print('[detect B2] num %s, kernel launches (= NMS rounds) %d'
          % (num, launches_b2))
    require(launches_b2 > 0, 'the detect path launched no kernel')
    require(all(x > 0 for x in num), 'no detections: %s' % num)
    require(tuple(preds['boxes'].shape) == (2, post, 7), 'boxes shape')
    require(bool(torch.isfinite(preds['boxes']).all())
            and bool(torch.isfinite(preds['scores']).all()), 'non-finite')
    for i in range(2):
        k = num[i]
        require(bool(preds['valid'][i, :k].all())
                and not bool(preds['valid'][i, k:].any()), 'valid prefix')
        labels = preds['labels'][i, :k]
        require(bool(((labels >= 1) & (labels <= 3)).all()), 'labels')
        require(bool((preds['boxes'][i, :k, 3:6] > 0).all()), 'box sizes')

    # 4. NMS indices: kernel vs plain, same candidates --------------------
    with torch.inference_mode():
        cand = candidates(det.model, det.model.forward(
            det.voxelize(pts2, mask2)), tc)
        sel_k, num_k = run_nms(cand, tc)
        sel_p, num_p = run_nms(cand, tc, ro.pair_overlap_batched_plain)
        nms_rounds = []

        def counted(a, b):
            out, count = ro.pair_overlap_batched_counted(a, b)
            nms_rounds.append((int(count), int(
                ro.overlap_maybe_nonzero_plain(a, b).sum()), out.numel()))
            return out

        sel_c, num_c = run_nms(cand, tc, counted)
    sync()
    require(torch.equal(sel_k, sel_p) and torch.equal(num_k, num_p),
            'NMS indices differ between kernel and plain')
    require(torch.equal(sel_c, sel_k) and torch.equal(num_c, num_k),
            'NMS indices differ with the counting launch')
    print('[nms] kernel and plain select the same indices: num %s, '
          'valid candidates %s' % (num_k.tolist(),
                                   cand['valid'].sum(1).tolist()))
    print('[nms] kernel A, pairs kept (not culled) per NMS round of the B2 detect '
          '(count, share of the round\'s pairs): %s' % ', '.join(
              '%d of %d (%.2f%%)' % (c, n, 100 * c / n)
              for c, _, n in nms_rounds))
    require(all(c == k for c, k, _ in nms_rounds), 'kernel A\'s count of '
            'pairs kept differs from the plain predicate\'s in an NMS '
            'round: %s' % nms_rounds)

    # 5. whole detect at B1, f32: GPU vs CPU ------------------------------
    cfg32 = copy.deepcopy(cfg)
    cfg32.MODEL.RPN.RPN_HEAD.ARGS['compute_dtype_test'] = ''
    outs = {}
    for name, d in (('gpu', dev), ('cpu', torch.device('cpu'))):
        det32 = detect_mod.build_detector(cfg32, d, seed=0)
        with torch.no_grad():
            det32.model.module.rpn_head.conv_cls.bias.zero_()
        t0 = time.perf_counter()
        ro.LAUNCHES = 0
        outs[name] = {k: v.cpu() for k, v in det32.detect(
            pts8[:1].to(d), mask8[:1].to(d)).items()}
        if name == 'gpu':
            sync()
            g1_launches = ro.LAUNCHES      # kernel A at G = 1: A'
        print('[gpu vs cpu] %s detect B1 f32: %.2f s' % (
            name, time.perf_counter() - t0))
        del det32
    sync()
    g, c = outs['gpu'], outs['cpu']
    n_g, n_c = int(g['num'][0]), int(c['num'][0])
    box_err = (g['boxes'] - c['boxes']).abs().max().item()
    print('[gpu vs cpu] num %d vs %d, max |box diff| %.3g; kernel A launches '
          'at G = 1 (A\') %d' % (n_g, n_c, box_err, g1_launches))
    require(n_g == n_c, 'GPU and CPU detection counts differ')
    require(box_err <= 1e-3, 'GPU and CPU boxes differ by %g' % box_err)

    # 6. timings ------------------------------------------------------------
    def stage_ms(points, mask, iters):
        t = {}
        with torch.inference_mode():
            vox = det.voxelize(points, mask)
            ret = det.model.forward(vox)
            cand = candidates(det.model, ret, tc)
            t['voxelize'] = cuda_ms(lambda: det.voxelize(points, mask), iters)
            t['model'] = cuda_ms(lambda: det.model.forward(vox), iters)
            t['predict'] = cuda_ms(lambda: det.model.predict(ret), iters)
            t['topk_decode'] = cuda_ms(
                lambda: candidates(det.model, ret, tc), iters)
            t['nms'] = cuda_ms(lambda: run_nms(cand, tc), iters)
        return t

    for b in (2, 8):
        pts, mask = pts8[:b].contiguous(), mask8[:b].contiguous()
        det.detect(pts, mask)
        sync()
        ro.LAUNCHES = 0
        det.detect(pts, mask)
        sync()
        rounds = ro.LAUNCHES
        batch_ms = []                 # three runs of 10 batches each
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(10):
                det.detect(pts, mask)
            sync()
            batch_ms.append(1e3 * (time.perf_counter() - t0) / 10)
        ms = sorted(batch_ms)[1]
        split = stage_ms(pts, mask, 5)
        print('[timing B%d] detect %.2f frames/s (median of 3 runs of 10 '
              'batches; ms per batch %s); voxelize %.2f ms, model %.2f ms, '
              'predict %.2f ms (of it top-k + decode %.2f ms, NMS %.2f ms); '
              'NMS rounds %d' % (
                  b, 1e3 * b / ms, ', '.join('%.2f' % x for x in batch_ms),
                  split['voxelize'], split['model'], split['predict'],
                  split['topk_decode'], split['nms'], rounds))
        busy, rows, ops = profile_detect(det, pts, mask)
        if not rows:
            print('[profile B%d] no device time recorded: not measured' % b)
            continue
        print('[profile B%d] device busy %.2f ms per batch of %.2f ms '
              'unprofiled: idle share %.1f%%; %d kernel names' % (
                  b, busy, ms, 100 * (1 - busy / ms), len(rows)))
        for t, name in rows[:10]:
            print('[profile B%d]   kernel %7.3f ms %5.1f%%  %s' % (
                b, t, 100 * t / busy, name[:90]))
        for t, name in ops[:10]:
            print('[profile B%d]   op     %7.3f ms %5.1f%%  %s' % (
                b, t, 100 * t / busy, name))
        ovl = sum(t for t, name in rows if 'rotated_overlap' in name)
        print('[profile B%d] rotated_overlap kernel: %.3f ms per batch '
              '(%.1f%% of device time)' % (b, ovl, 100 * ovl / busy))
    sync()

    second = run_second(dev, detect_mod.load_config(detect_mod.SECOND_CFG))
    dw_entry, b_train = run_train(
        dev, detect_mod.load_config(detect_mod.SECOND_CFG))
    second[0].update(b_train)
    xwin = run_xwin(dev, detect_mod.load_config(detect_mod.SECOND_CFG))
    require(g1_launches > 0, 'the B1 detect launched no kernel A at G = 1')
    evals = run_eval(dev, g1_launches, {
        'second.yaml': eval_config(detect_mod.SECOND_CFG),
        'pointpillar.yaml': eval_config(detect_mod.DEFAULT_CFG)})
    pp_eval_launches = run_pointpillar_train(dev, detect_mod.load_config())
    cli_paths = run_cli(dev)

    a_entry = kernel_entry(
        'rotated_overlap', 'pcdet_tpu_torch/csrc/rotated_overlap.cu',
        'pcdet_tpu/ops/pallas/rotated_overlap.py:280', launches_b2,
        max_abs_err, kernel_ms, plain_ms, a_work)
    a_entry['launches_by_path'] = {
        'pointpillar detect B2': launches_b2,
        'pointpillar trained checkpoint eval B2 (P4)': pp_eval_launches}
    kernels = [a_entry] + second + [dw_entry] + xwin + evals
    for entry in kernels:
        if entry['name'] in cli_paths:
            entry.setdefault('launches_by_path', {}).update(
                cli_paths[entry['name']])
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
