"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: PointPillar and
SECOND detect, SECOND training, the sparse convs' load strategies, the
evaluation (recall and KITTI AP) of both models, PointPillar training
through the epoch loop to a checkpoint and its evaluation, the CLI pair,
Part-A² / Part-A²-fc detect, evaluation and training, the BEVSEG fork's
pseudo-LiDAR training with its BEV segmentation head, and data-parallel
training over torch.distributed (on every card of the host where there are
two or more), and the rulebooks built on the card.

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
  3. full-width detect at B2 (kernel F's launch count > 0, num > 0);
  4. NMS indices through kernel F (one launch a call, every round on the
     card) == through the eager rounds on kernel A's plain version, same
     candidates, and the share of pairs kernel A kept in each eager round
     (its count, equal to the plain predicate's); kernel F against the
     plain eager rounds at the B2 and B8 NMS shapes: indices equal, its
     device time (queued), the eager rounds' time and the bound;
  5. the whole detect at B1 in f32: GPU vs CPU (counts equal, boxes 1e-3);
  6. timings: detect frames/s at B2 and B8, the voxelize / model / predict
     split (predict as top-k + decode and NMS), kernel F's launches and its
     device rounds a group, a torch.profiler breakdown by kernel and by op;
     kernel A beside the plain version comes from phase 2.
  S2. gather-GEMM kernels B (f32, FFMA) and C (bf16, tensor cores) vs their
      plain versions on rules of the real B2 books at conv2_1 (K=27, 32 ->
      32) and conv_out (K=3, 64 -> 128), with all-miss rows, n_live 0 and
      n_live mid-tile (bound 1e-5 * max |plain|), two launches bitwise
      equal, their device times, the share of (tile, tap) pairs they skip,
      and at conv2_1 cuBLAS on the pre-gathered rows (`gemm_only_ms`, the
      math without the gather: a yardstick, not the same function);
  S3. shipped second.yaml detect at B2 under the default loads (launches
      of C, E or E' as the loads choose, of kernel F one per NMS call,
      num > 0),
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
      and D's share and the idle share.
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
      step and its forward / backward split at B2 under each loads
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
      1e-4 relative, f64 loss and every gradient 1e-9); on the same 16
      train frames, ms per step and samples/s at B2 and B8 with the
      loader's prefetch (4 workers) and without (0): each epoch's first
      step (the pool's start and an empty queue) apart from the steady
      steps after it, the ms the loop waits on the loader, with the
      prefetch the device's idle share (torch.profiler), the upload;
  L3. the test CLI on L2's last checkpoint, 8 val frames at B2: kernel A's
      launches (from 0) > 0, recall, the official AP and the COCO strings
      finite, the logged AP string equal to the evaluator run again on the
      CLI's result.pkl; `--eval_all --max_waiting_mins 0` evaluates both
      checkpoints and lists them in eval_list_val.txt;
  L4. second.yaml through the same pair: 1 epoch of 2 B2 batches (books
      from the loader's `batch_transform`; B, D, D' launch; no tap outside
      its x-window), its checkpoint evaluated on 4 val frames (C, A).
  R1. PartA2.yaml at full width (41 x 1600 x 1408, 25088 voxels, UNet caps
      43520 / 29184 / 12288 / 10240, 211,200 anchors, proposals top-1024
      -> NMS 0.7 -> 100 RoIs, pool 14^3, SpConvRCNN, bf16 UNet, RPN and
      RCNN) on ring scans: detect at B2 with 28 launches of C and kernel A
      in both the proposal and the final NMS, num > 0; the RoI pool twice
      bitwise equal; the f32 detect on the card (28 launches of B) against
      the CPU's at B2 (RoIs equal in validity and labels, boxes within
      1e-3); under loads.fwd xwin and seg, bf16 and f32, 27 launches of E
      / E' (2 of them at the merge convs' (128, 64)), 1 of B / C and 10
      selector builds with no tap outside its window, and the rows
      detections; E and E' (f32, bf16) at (128, 64) against their plain
      versions on the level-3 subm book (1e-5 of max, bitwise equal to B /
      C and to a second launch) with device times; frames/s at B2 and B8
      with the voxelize / books / encoder / decoder / RPN / proposal / pool
      / RCNN / final NMS split and kernel A's launches a batch, and a
      torch.profiler breakdown at B8;
  R2. PartA2_fc.yaml (FCRCNN, 12^3) at B2: R1's checks but the f32 loads
      and the profile, frames/s with the split;
  R3. `eval_one_epoch` of PartA2.yaml on 16 SyntheticDataset scenes at B2
      and B8 (recall through A, A'' beside it, 28 launches of C a batch),
      V3's cross-checks, the GT oracle, eval frames/s and the detect /
      recall / annotate / evaluate split;
  R4. (in the CLI block, on L1's tree) the test CLI on PartA2.yaml over 4
      val frames with R8's checkpoint: C on every conv, A, the logged AP
      string equal to the evaluator on result.pkl;
  R5. PartA2.yaml training at full width (16000 train voxels, UNet caps by
      level_caps_frac, 211,200 anchors, proposals top-9000 -> NMS 0.8 ->
      512, 128 RoIs a sample, pool 14^3, f32) at B2 on ring scans through
      make_batch, 5 steps on one batch, the last 4 of the 512 RoI slots a
      sample given to moved and grown GT boxes (`parta2_gt_proposals`:
      random weights propose nothing near the scans' boxes): every loss
      term finite, the 5th loss below the 1st, fg RoIs and a regression
      and corner loss in every step, per step 28 + 27 launches of B, 27 of
      D' (the decoder's pairs among them), 1 of D, A's proposal rounds and
      one of the sampler's IoU, overflow/roi_pts;
  R6. one B1 step four ways (K32 the card, C32 the CPU, P64 the card
      through the plain versions in f64, C64 the CPU in f64; the last
      three take K32's RoIs, sampler picks and dropout masks): the f32
      losses within 1e-4 relative, the f64 loss and every f64 gradient
      within 1e-9 of max, a gradient into the RCNN's regression layer, fg
      RoIs in every run; the CPU's proposal layer on K32's head outputs
      equal to K32's (validity, labels; boxes within 1e-5 of their largest
      |coordinate|); D, D'', D' at (32, 16), (64, 32), (128, 64) and E, E'
      f32 at (64, 128) against their plain versions on the step's books
      (1e-4 / 1e-5 of max) with device times and bounds; the step under
      (rows, rows), (seg, seg) and (xwin, xwin) within 1e-5 (loss) and
      1e-3 of max (dW) of the rows step, no tap outside its window;
  R7. ms per step and samples/s at B2 and B8 (cuDNN's TF32 on, as the
      trainer runs), the batch built and prebuilt, make_batch's host
      stages, the step's device split, a torch.profiler list at B8;
      PartA2_fc.yaml (FCRCNN, 12^3, dropout) 3 steps at B2 with R5's
      checks;
  R8. (in the CLI block) the train CLI on PartA2.yaml, 1 epoch of 2 B2
      batches with the loader's books and targets: finite losses, B, D and
      D' launch, no tap outside its window.
  F1. the BEVSEG fork at the full width of tools/cfgs/argo/
      pointpillar_forward50x50_pseudolidar.yaml under `USE_PSEUDOLIDAR True
      MODE 3dobjdet+bev` (a 400 x 400 pillar grid, 16000 voxels x 32
      points, RPNV2 3/5/5 with 384 channels at 200 x 200, 240,000 anchors,
      the BEV head 384 -> 64 -> 64 -> 2): seeded depth maps of 375 x 1242
      (5-45 m) and a one-channel semantic map, both requiring gradients,
      lifted through `CalibrationTorch` (KITTI_P2 / KITTI_V2C) at stride 2
      (58,374 points a frame, padded to 65536), the semantic value painted
      into the 4th channel by a `point_feature_fn`, the hook voxelizing in
      the step, `loss_with_bev` on seeded BEV masks: 3 steps at B2, every
      loss term finite, bev_loss and miou in the tb, the 3rd loss below the
      1st, the BEV head's weights moved, d loss / d depth and d loss / d
      semantic finite and nonzero, overflow/voxelizer printed; then the
      config's detect at B2 (conv_cls bias zeroed) with kernel A in its
      NMS rounds and finite (2, 200, 200, 2) BEV logits;
  F2. one B1 step of F1's path from the same seeded weights and inputs,
      GPU vs CPU (`step_four_ways`): the f32 loss within 1e-4 relative, in
      f64 the loss, every parameter gradient and d loss / d depth and d
      semantic within 1e-9 of max;
  F3. the CLI pair with the fork's flags on a tree of 4 train + 2 val
      frames (`write_kitti_tree`) with 400 x 400 grey bev_DRIVABLE /
      bev_VEHICLE maps (zlib / struct): create_data, the train CLI 1 epoch
      of 2 B2 steps (finite losses, bev_loss logged), the test CLI on its
      checkpoint (SCORE_THRESH 0: kernel A in NMS and recall, launches > 0;
      the logged AP string equal to the evaluator on result.pkl) and
      `BEVSegEvalAccumulator` over the eval batches' BEV logits (finite
      test_miou);
  F4. ms per step (median of 3, batch prebuilt) and samples/s at B2 and B8
      with the hook and the BEV head and with neither (voxels made before
      the step, MODE 3dobjdet), at B2 with either alone; the re-voxelization's
      and the BEV head's forward + backward ms by CUDA events; the device's
      busy ms and top kernels at B2 with both and with neither
      (torch.profiler); with the card's name and power limit.
  M1. data-parallel SECOND (`tools/cfgs/second.yaml` at full width, train
      caps, TF32 off): a global B2 over two gloo ranks spawned on the one
      card (`parallel.ddp.launch_local`, one scan a rank, each joining the
      group over a file:// rendezvous), each rank with its own BN
      statistics against one process on the card with bn_groups 2, and
      synced BN against one BN group.  P64 (the plain versions in f64):
      the summed loss, every summed gradient and the BN running statistics
      within 1e-9 of the one process's.  K32 (kernels B, D, D'): the loss
      within 1e-4 relative; against the one process's P64, the ranks'
      relative L2 gradient error within twice the one process's K32 (or
      1e-3) and each gradient's own under 0.3 (f32 runs of one batch split
      two ways sit up to ~1e-1 of max apart in the BN-cancelling tensors);
      each rank's launches; 3 steps, after which every tensor of
      the state is bitwise equal on both ranks; the ms a step and the
      gloo all-reduce of the gradients per rank;
  M2. the same for Part-A² (`tools/cfgs/PartA2.yaml`, f32 on the kernels,
      the one process's P64 as the referee), the proposals, sampler picks
      and dropout masks of a one-process K32 run (its last 4 RoI slots a
      sample on moved GT boxes) injected on both sides; fg_sum, cls_valid
      and pos_norm per rank and global; kernel A (the sampler's IoU) in
      both ranks;
  M3. the train CLI under `python -m torch.distributed.run --standalone
      --nproc_per_node 1 ... --multi_host` (NCCL) on pointpillar.yaml, B2,
      2 epochs on L1's tree, with deterministic cuDNN, against the same
      epochs without a group (the two launches side by side): the same
      losses and every tensor of checkpoint_epoch_2 bitwise equal; the
      checkpoint restored into a trainer of other weights, every tensor
      the file's; NCCL's gradient all-reduce at W=1 per step; the test CLI
      on the checkpoint through kernel A, the logged AP string equal to
      the evaluator's on result.pkl.
  M4. (two cards or more; on one card one line says it did not run) every
      card of the host, W of them, with each card's name, power limit and
      the links between them (`nvidia-smi topo -m`): (a) every kernel (A,
      A', A'', B, C, D, D', D'', E and E' in f32 and bf16, the selector
      kernel) with its operands on cuda:1, launched from a thread whose
      current device is cuda:0, bitwise equal to the same launch on cuda:0
      and within its plain version's tolerance, each launch counted,
      nothing allocated on cuda:0; kernel A'''s blocks an SM and device
      time on every card; W ranks building kernel A and the host book
      builder at once into one fresh build directory, each launching A on
      its card; (b) M1 and M2 over W NCCL ranks, one card a rank, a B1
      share each, against one process on cuda:0 with bn_groups W or one BN
      group, with M1's and M2's checks and bounds; (c) the train CLI under
      torchrun --nproc_per_node W on pointpillar.yaml, B = 2W, 2 epochs on
      L1's tree, and at one rank, B2; the test CLI on the W-rank
      checkpoint through kernel A, its AP string equal to the evaluator's;
      (d) NCCL's gradient all-reduce ms of SECOND's and Part-A2's
      gradients against 2(W-1)/W x bytes over 450 GB/s, a rank's step ms
      against one process's at B1, samples/s across W cards against one.
  K1. (after R5-R7) the rulebooks built on the card (PCDET_HOST_BOOKS=0,
      `host_books.build_books_device`) for second.yaml at full width on
      B2 and B8 of `make_scans`, at the eval and the train caps: every
      tensor equal to the host books (native build, uploaded, decoded);
      the builders under torch.cuda's sync debug mode 'error' (a host sync
      raises); the host stage (copy, build, upload; host clock) against the
      device build (CUDA events; host clock); detect on device books equal
      to detect on host books (every prediction, the launches), frames/s
      both ways (median of 3 runs of 5 batches);
  K3. on K1's B2 conv2 level (spconv2's output set, 16 random channels):
      `SparseBottleneck(16, 16)` (1x1x1, 3x3x3, 1x1x1 subm convs and the
      1x1x1 projection: 4 launches of B) in eval and train mode, and
      `sparse_maxpool3d` 3 / 2 / 1 at spconv3's cap (its output set
      spconv3's book), each against its own CPU run within 1e-5 of max
      |out|; `subm_rules` of the level equal to its subm2 book;
  K2. PartA2.yaml at full width, B2: books and detect as K1; the eval
      forward with every inverse conv's book withheld (the geometric
      inverse rules) bitwise equal to key reuse; one train step on device
      books against host books from one seed (TF32 off, deterministic
      algorithms, warn only: the ops warned of are printed): loss, tb and
      every gradient bitwise equal, or within 1e-5 of max |g| where an op
      was warned of.
  Every phase prints its wall time, and the whole script's.

Prints the card's name and power limit, a JSON line with the kernels (A,
B, C, D, E, E', D'', D', A', A'', and apart E and E''s (128, 64)
instances of R1 and R6's D, D'', D' (32, 16), (64, 32), (128, 64) and E,
E' (64, 128)), each with its launches on its main path
(by path for A, B, C, D and D': the B2 detect, P4's evaluation, the CLI
pair's training and evaluation, A also the fork's argo detect and its
test CLI, and K1-K3's paths on device books), its error
against its plain version, its time and the plain version's, and its bound
(`bound_ms`, the larger of its bytes over 3.35 TB/s and its operations over
the peak rate of their type, 67 TFLOP/s for f32 outside the tensor cores
and 989 TFLOP/s for bf16, the H100 SXM's published dense rates, for this
run's inputs),
and as its last line {"ok": true, "device": {...}}.  Exits nonzero, with no
result line, when no CUDA device is present or any phase fails.
"""
import concurrent.futures
import contextlib
import copy
import gc
import glob
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
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


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, work,
                 library_ms=None):
    """One element of the `kernels` JSON line; `library_ms` is cuBLAS's
    yardstick where one was timed (`gemm_yardstick`, `dw_yardstick`)."""
    b_ms, b_by = bound_ms(*work)
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
            'bound_by': b_by, 'library_ms': library_ms}


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


_MARK = [time.perf_counter()]


def mark(tag):
    """Print the wall time since the previous mark (a block's parts)."""
    now = time.perf_counter()
    print('[time]   %s: %.1f s' % (tag, now - _MARK[0]))
    _MARK[0] = now


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


def fused_inputs(cand, tc):
    """Kernel F's operands for predict's NMS on `candidates`, formed as
    `nms.nms_bev_batched` forms them: (corners, area, valid)."""
    from pcdet_tpu_torch.ops import nms, rotated_iou
    boxes5 = cand['boxes5']
    g, a = boxes5.shape[:2]
    pre = min(int(tc.NMS_PRE_MAXSIZE_LAST), a)
    top_scores, order = nms.topk_stable(
        torch.where(cand['valid'], cand['rank'], nms.NEG_INF), pre)
    top = torch.gather(boxes5, 1, order[:, :, None].expand(g, pre, 5))
    return (rotated_iou.boxes5_to_corners(top).contiguous(),
            nms._box_area(top).contiguous(),
            (top_scores > nms.NEG_INF / 2).contiguous())


def fused_work(geo, area, valid):
    """(operations, bytes) of one launch of kernel F: the operands read once
    and keep and the round counts written once.  The operations are left
    out: the rounds' data decides them, and the floor is the bytes'."""
    g, pre = area.shape
    return 0, (4 * (geo.numel() + area.numel()) + valid.numel() + g * pre
               + 4 * g)


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


def pre_gathered(table, rules, live):
    """The live rows' table rows of every tap, (sum of live rows, K Cin)."""
    k, cin = rules.shape[2], table.shape[2]
    return torch.cat([table[i, rules[i, :int(n)].long()].reshape(-1, k * cin)
                      for i, n in enumerate(live.tolist())])


def gemm_yardstick(table, rules, w, live):
    """ms of cuBLAS's (sum of live rows, K Cin) @ (K Cin, Cout) on the
    pre-gathered rows of every tap, in the operands' dtype: the math of a
    gather-GEMM without its gather (not the same function)."""
    k, cin, cout = w.shape
    gathered = pre_gathered(table, rules, live)
    flat = w.reshape(k * cin, cout)
    return device_ms(lambda: torch.matmul(gathered, flat), 20)


def dw_yardstick(table, rules, g, live):
    """ms of cuBLAS's (K Cin, sum of live rows) @ (sum of live rows, Cout)
    on the pre-gathered rows of every tap and the live rows of g: the math
    of a dW over a rulebook without its gather (not the same function)."""
    gathered = pre_gathered(table, rules, live).t()
    g_live = torch.cat([g[i, :int(n)] for i, n in enumerate(live.tolist())])
    return device_ms(lambda: torch.matmul(gathered, g_live), 20)


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
                                  + 4 * b * v_out * cout),
                              'library_ms': gemm_ms}
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


def reset_overlap():
    """Zero kernel A's and kernel F's launch counters."""
    from pcdet_tpu_torch.ops import nms_fused as nf
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    ro.LAUNCHES = 0
    nf.LAUNCHES = 0


def overlap_launches():
    """(kernel A's launches, kernel F's) since `reset_overlap`.  Each launch
    of F adds 1 to A's counter as well (F is A's fused form), so A's own
    are the difference."""
    from pcdet_tpu_torch.ops import nms_fused as nf
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    return ro.LAUNCHES - nf.LAUNCHES, nf.LAUNCHES


def run_second(dev, cfg, batches=(2, 8)):
    """Phases S1-S5 on SECOND; returns the kernels' JSON entries."""
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.ops import cuda_build, host_books, sparse
    from pcdet_tpu_torch.ops import gather_gemm as gg
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
    reset_overlap()
    preds = det.detect(pts2, mask2)
    sync()
    counts = nonzero(all_launches())
    launches_a, launches_f = overlap_launches()
    launches_c = counts.get('gather_gemm_bf16', 0)
    num = second_detect_checks(preds, post, 2)
    with torch.inference_mode():
        ret = det.model.forward(dict(vox, books=books))
    drops = {k: v.tolist() for k, v in ret['overflow'].items()}
    expect = forward_launches(det.loads, det.model.module.compute_dtype)
    print('[second S3] detect B2 (second.yaml, bf16 sparse stack, loads %s): '
          'num %s; launches %s (12 convs per batch), kernel A %d, kernel F '
          '%d (one per NMS call); input voxels %s of cap %d, voxelizer '
          'overflow %s; per-level drops %s'
          % (tuple(det.loads), num, counts, launches_a, launches_f,
             vox['voxel_mask'].sum(1).tolist(), det.max_voxels,
             voxel_overflow(det, pts2, mask2), drops))
    require(launches_c > 0, 'the SECOND path launched no kernel C')
    require(launches_f > 0, 'the SECOND path launched no kernel F')
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
            for _ in range(5):
                det.detect(pts, mask)
            sync()
            batch_ms.append(1e3 * (time.perf_counter() - t0) / 5)
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
        print('[second S5 B%d] detect %.2f frames/s (median of 3 runs of 5 '
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
                            k['work'], k['library_ms'])
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
        lib_ms = dw_yardstick(feats, rules, g, live)
        print('[train T2] kernel D conv_out yardstick: cuBLAS on the '
              'pre-gathered rows %.4f ms (not the same function; kernel %.4f '
              'ms)' % (lib_ms, ms))
        stats['d'] = {'err': err, 'rel': err / scale, 'ms': ms,
                      'plain_ms': plain_ms, 'work': gather_work(
                          feats, rules, live, cout, 4 * k,
                          4 * cout * int(live.sum()) + 4 * k * cin * cout),
                      'library_ms': lib_ms}
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


def profile_train(trainer, batch, iters=2):
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


def run_train(dev, cfg, batches=(2, 8), steps=5, timed_steps=2):
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

    mark('T1-T3')
    # T4. one train step at B1: GPU vs CPU, kernels vs plain, f64 --------
    # K32: the card through kernels B and D; P32 / P64: the card through
    # their plain versions in f32 / f64; C32 / C64: the CPU in f32 / f64.
    out = {}
    for name, d, dtype in (('K32', dev, torch.float32),
                           ('P32', dev, torch.float32),
                           ('P64', dev, torch.float64),
                           ('C32', torch.device('cpu'), torch.float32),
                           ('C64', torch.device('cpu'), torch.float64)):
        with plain_sparse(name.startswith('P')):
            tr = build_trainer(cfg, d, seed=0, total_steps=total)
            tr.model.module.to(dtype)
            t0 = time.perf_counter()
            b1 = tr.make_batch(pts_all[:1].to(d), mask_all[:1].to(d),
                               gt_np[:1])
            for key in ('voxels', 'box_reg_targets'):
                b1[key] = b1[key].to(dtype)
            loss, _, grads = train_state.loss_and_grads(
                tr.model, tr.state.params, b1)
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

    mark('T4')
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
            for _ in range(timed_steps):
                trainer.step(trainer.make_batch(pts, mask, gt))
            sync()
            full.append(1e3 * (time.perf_counter() - t0) / timed_steps)
            t0 = time.perf_counter()
            for _ in range(timed_steps):
                trainer.step(batch)
            sync()
            pre.append(1e3 * (time.perf_counter() - t0) / timed_steps)
        ms_full, ms_pre = sorted(full)[1], sorted(pre)[1]
        host = host_stages(trainer, pts, mask, gt, 3)
        dev_split = train_step_split(trainer, batch, 3)
        print('[train T5 B%d] step with the batch built: %.2f ms (%.2f '
              'samples/s; ms per step %s); prebuilt batch: %.2f ms (%.2f '
              'samples/s; %s); median of 3 runs of %d steps' % (
                  b, ms_full, 1e3 * b / ms_full,
                  ', '.join('%.2f' % x for x in full), ms_pre,
                  1e3 * b / ms_pre, ', '.join('%.2f' % x for x in pre),
                  timed_steps))
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
    sync()
    d = kstats['d']
    return (kernel_entry('gather_dw', 'pcdet_tpu_torch/csrc/gather_dw.cu',
                         'pcdet_tpu/ops/pallas/gather_gemm.py:882',
                         counts.get('gather_dw', 0), d['err'], d['ms'],
                         d['plain_ms'], d['work'], d['library_ms']),
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
            'gather_dw': 'pcdet_tpu/ops/pallas/gather_gemm.py:882',
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
                    lib_ms = gemm_yardstick(table, rules, w, live)
                    stats[key] = {'err': err, 'ms': ms, 'plain_ms': plain_ms,
                                  'work': gather_work(
                                      table, rules, live, cout,
                                      8 * base.shape[2],
                                      w.numel() * w.element_size()
                                      + 4 * b * v_out * cout),
                                  'library_ms': lib_ms}
                    print('[xwin X1] %s %s conv2_1: kernel %.4f ms, plain '
                          '%.4f ms, yardstick cuBLAS on the pre-gathered '
                          'rows %.4f ms' % (variant, tag, ms, plain_ms,
                                            lib_ms))
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
                lib_ms = dw_yardstick(feats, rules, g, live)
                stats['gather_dw_' + variant] = {
                    'err': err, 'ms': ms, 'plain_ms': plain_ms,
                    'work': gather_work(feats, rules, live, cout,
                                        8 * base.shape[2],
                                        4 * cout * int(live.sum())
                                        + 4 * k * cin * cout),
                    'library_ms': lib_ms}
                print('[xwin X1] dW %s conv2_1: kernel %.4f ms (device), '
                      'plain %.4f ms, yardstick cuBLAS on the pre-gathered '
                      'rows %.4f ms' % (variant, ms, plain_ms, lib_ms))
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

    # end to end: detect under each loads.fwd
    dets = {fwd: second_detector(cfg, dev, sparse.Loads(fwd, 'rows'))
            for fwd in ('rows', 'xwin', 'seg')}
    for b in (2, 8):
        p, m = pts[:b].contiguous(), mask[:b].contiguous()
        for order in (('rows', 'xwin', 'seg'),):
            for fwd in order:
                det = dets[fwd]
                det.detect(p, m)
                sync()
                runs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    for _ in range(2):
                        det.detect(p, m)
                    sync()
                    runs.append(1e3 * (time.perf_counter() - t0) / 2)
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
    for b in (2,):
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
                trainer.step(batch)
                sync()
                runs.append(1e3 * (time.perf_counter() - t0))
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
    mark('X1')
    launches = xwin_detect(dev, cfg, pts2, mask2)                # X2
    launches.update(xwin_train(dev, cfg, pts, mask, gt_np))      # X3
    mark('X2-X3')
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
            st['err'], st['ms'], st['plain_ms'], st['work'],
            st.get('library_ms')))
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
        reset_overlap()
        ro.LAUNCHES_SORTED = 0
        result = eval_loop.eval_one_epoch(det, iter(batches), dataset, cfg)
        sync()
        a, f = overlap_launches()
        counts = dict(nonzero(all_launches()), rotated_overlap=a,
                      nms_fused=f, rotated_overlap_sorted=ro.LAUNCHES_SORTED)
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
          'of %d), F %d (NMS), A\'\' %d; sparse convs %s' % (
              name, counts['rotated_overlap'], recall_a, len(checker.grids),
              counts['nms_fused'], counts['rotated_overlap_sorted'],
              {k: v for k, v in counts.items()
               if not k.startswith(('rotated_overlap', 'nms_fused'))}))
    require(result['recall/gt'] > 0, '%s: recall/gt is 0' % name)
    require(all(np.isfinite(float(v)) for v in result.values()),
            '%s: a result is not finite' % name)
    require(recall_a == len(checker.grids) > 0,
            '%s: kernel A not launched once per recall grid' % name)
    require(counts['nms_fused'] > 0, '%s: kernel F not launched' % name)
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
        detect (0: kernel F runs its NMS)
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

    mark('V1-V3')
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

    # A' holds the G = 1 NMS shape's times; phase 5's B1 detect runs its NMS
    # on kernel F, so A' launches 0 times there; the recall group's times
    # are printed
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
    'vfe', 'rpn_head.blocks.<i>', 'rpn_head.deblocks.<i>', 'rpn_head.conv_*',
    'bev_seg_head'; an input ('input.<name>') is its own group."""
    out = {}
    for n in names:
        parts = n.split('.')
        if parts[0] == 'input':
            out[n] = n
            continue
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
    relative, the f64 loss and every f64 gradient within 1e-9.  `make` may
    also return {name: input tensor} beside the batch: the loss's gradients
    by those inputs are compared too.  Returns {'G32' / 'C32' / 'G64' /
    'C64': (loss, {name: grad on the CPU in f64}, the step's voxel
    coordinates on the CPU)}."""
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
        b, inputs = b if isinstance(b, tuple) else (b, {})
        loss, _, grads = train_state.loss_and_grads(
            tr.model, list(tr.state.params) + list(inputs.values()), b)
        names = ([n for n, _ in tr.model.module.named_parameters()]
                 + list(inputs))
        coords = tr.step_coords(b) if tr.revoxelizes else b['coordinates']
        out[name] = (float(loss), {n: g.cpu().double()
                                   for n, g in zip(names, grads)},
                     coords.cpu())
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


def run_pointpillar_train(dev, cfg, steps=5, timed_steps=2):
    """Phases P1-P4 on PointPillar training; returns kernel A's launches in
    P4's evaluation of the trained checkpoint."""
    import tempfile

    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.datasets.synthetic import (SyntheticDataset,
                                                    eval_batches)
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

    mark('P1')
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

    mark('P2')
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
            for _ in range(timed_steps):
                trainer.step(trainer.make_batch(pts, mask, gt))
            sync()
            full.append(1e3 * (time.perf_counter() - t0) / timed_steps)
            t0 = time.perf_counter()
            for _ in range(timed_steps):
                trainer.step(batch)
            sync()
            pre.append(1e3 * (time.perf_counter() - t0) / timed_steps)
        ms_full, ms_pre = sorted(full)[1], sorted(pre)[1]
        host, nbytes = pp_host_stages(trainer, pts, mask, gt)
        dev_split = train_step_split(trainer, batch)
        print('[pp train P3 B%d] step with the batch built: %.2f ms (%.2f '
              'samples/s; ms per step %s); prebuilt batch: %.2f ms (%.2f '
              'samples/s, %.2f ms per sample; %s); median of 3 runs of %d '
              'steps' % (b, ms_full, 1e3 * b / ms_full,
                         ', '.join('%.2f' % x for x in full), ms_pre,
                         1e3 * b / ms_pre, ms_pre / b,
                         ', '.join('%.2f' % x for x in pre), timed_steps))
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

    mark('P3')
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
    reset_overlap()
    result = eval_one_epoch(det, iter(batches), dataset, eval_cfg)
    sync()
    a_launches, f_launches = overlap_launches()
    print('[pp train P4] eval of the checkpoint, %d frames at B2: '
          'recall/gt %s, recall/rcnn_0.5 %s, Car_3d_moderate %s, '
          'overflow/voxelizer %s, sec_per_example %.4f; kernel A launches %d '
          '(recall), kernel F %d (NMS)'
          % (len(dataset), result['recall/gt'], result['recall/rcnn_0.5'],
             result.get('Car_3d_moderate'), result.get('overflow/voxelizer'),
             result['sec_per_example'], a_launches, f_launches))
    require(a_launches > 0 and f_launches > 0, 'the checkpoint\'s '
            'evaluation launched kernel A %d, kernel F %d times'
            % (a_launches, f_launches))
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
    return a_launches, f_launches


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


def _png(width, height, colour, raw):
    """A PNG of 8-bit samples of colour type `colour`, its scanlines `raw`
    (each led by filter byte 0), written with zlib and struct only."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8,
                                         colour, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))


def png_bytes(width, height):
    """A black RGB PNG."""
    return _png(width, height, 2, (b'\x00' + bytes(3 * width)) * height)


def grey_png_bytes(pixels):
    """An 8-bit grey PNG of (H, W) uint8 `pixels`."""
    h, w = pixels.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels], 1)
    return _png(w, h, 0, rows.astype(np.uint8).tobytes())


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


def run_cli(dev, workdir=None):
    """Phases L1-L4; returns the launches of the CLI paths by kernel entry
    name: {name: {'cli_train' / 'cli_eval': n}}.  The KITTI tree and the
    outputs go under `workdir` (kitti/, out/) where one is given, else
    under a temporary directory."""
    import contextlib
    import os
    import pickle
    import tempfile

    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.datasets import build_dataloader
    from pcdet_tpu_torch.datasets.kitti import kitti_eval_cli
    from pcdet_tpu_torch.datasets.kitti.kitti_eval import eval as kitti_eval
    from pcdet_tpu_torch.ops import host_books, sparse
    from pcdet_tpu_torch.tools import test as test_cli
    from pcdet_tpu_torch.tools import train as train_cli
    from pcdet_tpu_torch.train.trainer import build_trainer

    here = os.path.dirname(os.path.abspath(__file__))
    pp_cfg = str(detect_mod.DEFAULT_CFG)
    second_cfg = str(detect_mod.SECOND_CFG)
    paths = {}
    with (contextlib.nullcontext(workdir) if workdir
          else tempfile.TemporaryDirectory()) as tmp:
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
        mark('L1-L2 checks')
        # ms per step with the loader's prefetch (4 thread workers) and
        # without (0 workers), B2 and B8, on L1's 16 train frames, so that
        # each epoch's cold first batch is one of 8 / 2; the device's busy
        # share with the prefetch; the upload on its own
        tcfg = cfg
        n_frames = len(infos['train'])
        trainer = build_trainer(tcfg, dev, seed=0, total_steps=1000)
        for b, epochs in ((2, 1), (8, 1)):
            for w in (4, 0):
                t = loader_epochs(trainer, tcfg, b, w, epochs,
                                  warm_up=(w == 4), profile=(w == 4))
                idle = ('busy %.2f ms a step, idle %.1f%% of a steady step, '
                        '%.1f%% of all' % (
                            t['busy'], 100 * (1 - t['busy'] / t['steady']),
                            100 * (1 - t['busy'] / t['ms']))
                        if t['busy'] else 'idle not measured')
                alone = ('the loader alone %.2f ms a steady batch, %.2f its '
                         'first; ' % (t['alone'], t['alone_first'])
                         if t['alone'] else '')
                print('[cli L2 B%d] loader with %d workers, %d train frames: '
                      'steady %.2f ms per step (%.2f samples/s; %d steps '
                      'over %d epochs); per steady step, host clock: waiting '
                      'on the loader %.2f ms, in upload %.2f ms, in step '
                      '%.2f ms; each epoch\'s first step %.2f ms (waiting '
                      '%.2f); all steps %.2f ms (%.2f samples/s); %sdevice '
                      '%s' % (
                          b, w, n_frames, t['steady'],
                          1e3 * b / t['steady'],
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

        mark('L2 loader timing')
        # L3. the test CLI on the last checkpoint, 8 val frames at B2 --------
        eval_sets = sets + ['MODEL.TEST.SCORE_THRESH', '0.0']
        targv = ['--cfg_file', pp_cfg, '--batch_size', '2', '--workers', '4',
                 '--extra_tag', 'chip_smoke', '--device', dev.type, '--ckpt',
                 os.path.join(ckpt_dir, 'checkpoint_epoch_2.pth'),
                 '--set'] + eval_sets
        reset_overlap()
        t0 = time.perf_counter()
        tout = test_cli.main(targv)
        sync()
        a_launches, f_launches = overlap_launches()
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
              'in %.2f s: kernel A launches %d, kernel F %d; recall/gt %s, '
              'rcnn_0.5 %s, '
              'rcnn_0.7 %s; %d detections; Car_3d_moderate %s; '
              'sec_per_example %.4f; logged AP string == the evaluator on '
              'result.pkl: %s' % (
                  len(det_annos), time.perf_counter() - t0, a_launches,
                  f_launches, result['recall/gt'], result['recall/rcnn_0.5'],
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
        paths['nms_fused'] = {'cli_eval': f_launches}
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

        mark('L3')
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
        reset_overlap()
        t0 = time.perf_counter()
        seout = test_cli.main(
            ['--cfg_file', second_cfg, '--batch_size', '2', '--workers', '4',
             '--extra_tag', 'chip_smoke', '--device', dev.type, '--ckpt', os.path.join(
                 out_root, 'output', 'second', 'chip_smoke', 'ckpt',
                 'checkpoint_epoch_1.pth'), '--set'] + s_sets
            + ['MODEL.TEST.SCORE_THRESH', '0.0'])
        sync()
        eval_counts = nonzero(all_launches())
        s_a, s_f = overlap_launches()
        s_result = seout['results'][1][1]
        print('[cli L4] test CLI second.yaml on its checkpoint, 4 val frames '
              'at B2 in %.2f s: launches %s, kernel A %d, kernel F %d; '
              'recall/gt %s, rcnn_0.5 %s; Car_3d_moderate %s' % (
                  time.perf_counter() - t0, eval_counts, s_a, s_f,
                  s_result['recall/gt'], s_result['recall/rcnn_0.5'],
                  s_result.get('Car_3d_moderate')))
        require(eval_counts.get('gather_gemm_bf16', 0) > 0 and s_a > 0
                and s_f > 0, 'SECOND test CLI: launches %s, kernel A %d, '
                'kernel F %d' % (eval_counts, s_a, s_f))
        require(all(np.isfinite(float(v)) for v in s_result.values()),
                'SECOND test CLI: a result is not finite')
        del seout
        sync()

        mark('L4')
        # R8 and R4. Part-A2 through the train and test CLIs, 4 + 4 frames --
        parta2_paths = parta2_cli(dev, root, out_root, s_sets,
                                  infos['val'][:4])
        sync()
    paths['rotated_overlap']['cli_eval second'] = s_a
    paths['nms_fused']['cli_eval second'] = s_f
    paths['gather_gemm_f32'] = {'cli_train': train_counts['gather_gemm_f32']
                                + train_counts['gather_gemm_f32_dgrad']}
    paths['gather_dw'] = {'cli_train': train_counts['gather_dw']}
    paths['gather_dw_seg'] = {'cli_train': train_counts['gather_dw_seg']}
    paths['gather_gemm_bf16'] = {'cli_eval': eval_counts['gather_gemm_bf16']}
    for name, by_path in parta2_paths.items():
        paths.setdefault(name, {}).update(by_path)
    return paths


# ----------------------------------------------------------------------------
# R1-R4: Part-A² and Part-A²-fc, detect and evaluation
# ----------------------------------------------------------------------------

PARTA2_CONVS = 28        # 12 in the encoder, 4 per UR block; 27 of them kw=3
PARTA2_SELECTORS = 10    # window loads: 7 books' selectors, 3 transposed


def parta2_f32(cfg):
    """`cfg` with the UNet, the RPN and the RCNN in f32."""
    cfg32 = copy.deepcopy(cfg)
    for args in (cfg32.MODEL.RPN.BACKBONE.ARGS, cfg32.MODEL.RPN.RPN_HEAD.ARGS,
                 cfg32.MODEL.RCNN):
        args['compute_dtype_test'] = ''
    return cfg32


def parta2_launches(loads, dtype):
    """The sparse-conv launches of one Part-A² batch under `loads`: the 27
    kw=3 convs by loads.fwd, conv_out on B / C; window loads build 10
    selector sets."""
    t = 'bf16' if dtype == torch.bfloat16 else 'f32'
    if loads.fwd == 'rows':
        return {'gather_gemm_' + t: PARTA2_CONVS}
    return {'gather_gemm_' + t: 1,
            'gather_gemm_%s_%s' % (loads.fwd, t): PARTA2_CONVS - 1,
            'xwin_selectors': PARTA2_SELECTORS}


def parta2_run(det, pts, mask):
    """One B-batch through the model with the books built, on the device:
    (the voxelized batch with its books, the forward's outputs, the
    predictions), kernel F's launches by the proposal NMS and the final."""
    with torch.inference_mode():
        vox = det.voxelize(pts, mask)
        vox['books'] = det.books(vox)
        sync()
        reset_overlap()
        ret = det.model.forward(vox)
        sync()
        f_prop = overlap_launches()[1]
        reset_overlap()
        preds = det.model.predict(ret)
        sync()
    return vox, ret, preds, (f_prop, overlap_launches()[1])


def parta2_gpu_vs_cpu(tag, cfg, dev, pts, mask):
    """The f32 detect on the card (kernel B) against the CPU's, stage by
    stage: heads, RoIs, RCNN outputs, detections (1e-3 on the boxes)."""
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import sparse
    cfg32 = parta2_f32(cfg)
    outs = {}
    for name, d in (('gpu', dev), ('cpu', torch.device('cpu'))):
        det32 = second_detector(cfg32, d, sparse.ROWS)
        reset_launches()
        t0 = time.perf_counter()
        _, ret, preds, _ = parta2_run(det32, pts.to(d), mask.to(d))
        if name == 'gpu':
            sync()
            launches_b = gg.LAUNCHES['gather_gemm_f32']
            stray_c = gg.LAUNCHES['gather_gemm_bf16']
        outs[name] = ({k: ret[k].cpu() for k in ('cls_preds', 'box_preds',
                                                 'u_seg_preds')},
                      {k: v.cpu() for k, v in ret['rcnn'].items()},
                      {k: v.cpu() for k, v in preds.items()})
        print('[parta2 %s] %s detect B%d f32: %.2f s' % (
            tag, name, pts.shape[0], time.perf_counter() - t0))
        if name == 'gpu':
            gpu_det = det32
        del det32
    (hg, rg, pg), (hc, rc, pc) = outs['gpu'], outs['cpu']
    head_err = {k: (hg[k] - hc[k]).abs().max().item() / max(
        hc[k].abs().max().item(), 1e-30) for k in hg}
    same_rois = (torch.equal(rg['roi_valid'], rc['roi_valid'])
                 and torch.equal(rg['roi_labels'], rc['roi_labels']))
    roi_err = (rg['rois'] - rc['rois']).abs().max().item()
    rcnn_err = max((rg[k] - rc[k]).abs().max().item()
                   for k in ('rcnn_cls', 'rcnn_reg'))
    num_g, num_c = pg['num'].tolist(), pc['num'].tolist()
    box_err = (pg['boxes'] - pc['boxes']).abs().max().item()
    print('[parta2 %s] f32 GPU vs CPU at B%d: heads max |diff| / max %s; RoI '
          'valid and labels equal %s, max |RoI diff| %.3g; max |RCNN diff| '
          '%.3g; num %s vs %s, max |box diff| %.3g; kernel B launches %d, '
          'kernel C %d' % (tag, pts.shape[0], {k: '%.3g' % v for k, v in
                                               head_err.items()}, same_rois,
                           roi_err, rcnn_err, num_g, num_c, box_err,
                           launches_b, stray_c))
    require(launches_b == PARTA2_CONVS and stray_c == 0, 'the f32 Part-A2 '
            'path launched B %d times, C %d' % (launches_b, stray_c))
    require(same_rois and roi_err <= 1e-3, 'GPU and CPU RoIs differ')
    require(num_g == num_c and min(num_g) > 0,
            'GPU and CPU detection counts differ: %s vs %s' % (num_g, num_c))
    require(box_err <= 1e-3, 'GPU and CPU boxes differ by %g' % box_err)
    return gpu_det, pg


def parta2_loads(tag, cfg, dev, pts, mask, ref, dtype):
    """Detect under loads.fwd xwin and seg against the rows detect `ref`:
    the launches the loads predict, no tap outside its window, the same
    detections (E / E' give B's / C's bits).  Returns E's and E''s launches
    at (128, 64)."""
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    pairs = {}
    for fwd in ('xwin', 'seg'):
        loads = sparse.Loads(fwd, 'seg')
        det = second_detector(cfg, dev, loads)
        det.detect(pts, mask)
        sync()
        reset_launches()
        gx.PAIR_LAUNCHES.clear()
        got = det.detect(pts, mask)
        sync()
        counts = nonzero(all_launches())
        t = 'bf16' if dtype == torch.bfloat16 else 'f32'
        name = 'gather_gemm_%s_%s' % (fwd, t)
        pairs[name] = gx.PAIR_LAUNCHES.get((name, 128, 64), 0)
        clamped = {k: int(v) for k, v in
                   det.model.module.rpn_net.xwin_clamped.items()}
        box_err = (got['boxes'] - ref['boxes'].to(dev)).abs().max().item()
        bitwise = all(torch.equal(got[k], ref[k].to(dev)) for k in got)
        print('[parta2 %s] loads %s %s at B%d: num %s (rows %s), max |box '
              'diff| vs rows %.3g, bitwise equal %s; launches %s, of them at '
              '(128, 64) %d; taps outside their window %s' % (
                  tag, tuple(loads), t, pts.shape[0], got['num'].tolist(),
                  ref['num'].tolist(), box_err, bitwise, counts, pairs[name],
                  sum(clamped.values())))
        require(counts == parta2_launches(loads, dtype), 'launches %s, want '
                '%s' % (counts, parta2_launches(loads, dtype)))
        require(pairs[name] == 2, '%s launched %d times at (128, 64), want 2'
                % (name, pairs[name]))
        require(len(clamped) == PARTA2_SELECTORS
                and not any(clamped.values()), 'taps outside their window: '
                '%s' % clamped)
        require(torch.equal(got['num'], ref['num'].to(dev))
                and box_err <= 1e-3, 'loads %s: detections differ from rows'
                % (tuple(loads),))
        del det
    return pairs


def parta2_pool_repeat(tag, det, vox, ret):
    """The RoI pool twice on the same inputs: the same bits."""
    with torch.inference_mode():
        rois = ret['rcnn']['rois']
        a = det.model.pool(ret, vox, rois)
        b = det.model.pool(ret, vox, rois)
        sync()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    cells = int((a[0].abs().sum(-1) > 0).sum())
    print('[parta2 %s] RoI pool twice: bitwise equal %s; %d occupied cells '
          'over %d RoIs; points past the cap %d' % (
              tag, same, cells, rois.shape[0] * rois.shape[1], int(a[2])))
    require(same, 'the RoI pool is not deterministic')
    require(cells > 0, 'the RoI pool found no voxel in any RoI')


def parta2_split(det, pts, mask, iters=5):
    """CUDA-event ms of a detect's stages on one batch: voxelize, books
    (host clock: coords to the host, the build, the upload), the UNet's
    encoder, its decoder (the UNet less its encoder), RPN, the proposal
    layer, the RoI pool, the RCNN and the final NMS (decode and
    post-processing)."""
    from pcdet_tpu_torch.ops import sparse
    model = det.model
    module = model.module
    unet = module.rpn_net
    cd = module.compute_dtype
    t = {}
    with torch.inference_mode():
        vox = det.voxelize(pts, mask)
        t['voxelize'] = cuda_ms(lambda: det.voxelize(pts, mask), iters)
        books_ms = []
        for _ in range(iters):
            sync()
            t0 = time.perf_counter()
            books = det.books(vox)
            sync()
            books_ms.append(1e3 * (time.perf_counter() - t0))
        t['books'] = sorted(books_ms)[iters // 2]
        vox['books'] = books
        feats = module.vfe(vox['voxels'], vox['num_points_per_voxel'],
                           vox['coordinates'], vox['voxel_mask'])
        level = sparse.from_voxelizer(feats, vox['coordinates'],
                                      vox['voxel_mask'], module.sparse_shape)
        cap = level.features.shape[1]
        t['encoder'] = cuda_ms(lambda: unet.encode(
            level, books, cd, unet.shared_books(books, cap)), iters)
        t['decoder'] = cuda_ms(lambda: unet(level, books, cd),
                               iters) - t['encoder']
        ret = model.forward(vox)
        t['rpn'] = cuda_ms(lambda: module.rpn_head(ret['spatial_features']),
                           iters)
        t['proposal'] = cuda_ms(lambda: model.proposals(ret), iters)
        rois = ret['rcnn']['rois']
        t['pool'] = cuda_ms(lambda: model.pool(ret, vox, rois), iters)
        part, rpn, _ = model.pool(ret, vox, rois)
        part, rpn = part.flatten(0, 1), rpn.flatten(0, 1)
        t['rcnn'] = cuda_ms(lambda: module.rcnn_net(part, rpn), iters)
        t['final_nms'] = cuda_ms(lambda: model.predict(ret), iters)
    return t


def parta2_times(tag, det, pts8, mask8, batches, profile=False):
    """frames/s (median of 3 runs of 5 batches) and the stage split at each
    batch size, with kernel A's launches a batch (proposal NMS, final
    NMS); a torch.profiler breakdown at the last size when `profile`."""
    for b in batches:
        pts, mask = pts8[:b].contiguous(), mask8[:b].contiguous()
        det.detect(pts, mask)
        sync()
        reset_launches()
        _, _, _, (f_prop, f_final) = parta2_run(det, pts, mask)
        counts = nonzero(all_launches())
        batch_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(5):
                det.detect(pts, mask)
            sync()
            batch_ms.append(1e3 * (time.perf_counter() - t0) / 5)
        ms = sorted(batch_ms)[1]
        t = parta2_split(det, pts, mask)
        print('[parta2 %s B%d] detect %.2f frames/s (median of 3 runs of 5 '
              'batches; ms per batch %s); split (ms): %s; sum of the split '
              '%.2f; launches a batch: %s, kernel F %d (proposal NMS %d, '
              'final NMS %d)' % (
                  tag, b, 1e3 * b / ms, ', '.join('%.2f' % x
                                                  for x in batch_ms),
                  ', '.join('%s %.3f' % kv for kv in t.items()),
                  sum(t.values()), counts, f_prop + f_final, f_prop,
                  f_final))
    if not profile:
        return
    busy, rows, ops = profile_detect(det, pts, mask)
    if not rows:
        print('[parta2 %s B%d] no device time recorded: not measured'
              % (tag, b))
        return
    print('[parta2 %s B%d] device busy %.2f ms per batch of %.2f ms '
          'unprofiled: idle share %.1f%%' % (tag, b, busy, ms,
                                            100 * (1 - busy / ms)))
    for tt, name in rows[:12]:
        print('[parta2 %s B%d]   kernel %7.3f ms %5.1f%%  %s' % (
            tag, b, tt, 100 * tt / busy, name[:90]))
    for tt, name in ops[:12]:
        print('[parta2 %s B%d]   op     %7.3f ms %5.1f%%  %s' % (
            tag, b, tt, 100 * tt / busy, name))


def window_pair_vs_plain(dev, books):
    """E and E' (f32, bf16) at (128, 64), the merge convs' pair, against
    their plain versions on the level-3 subm book of a real B2 batch
    (up3_m's), n_live real, mid-tile and 0: 1e-5 of max |plain|, bitwise
    equal to B / C on the rules and to a second launch; device times.
    Returns the kernels line's stats by LAUNCHES name."""
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    rules = books['subm3']
    in_mask = books['spconv3'][2]
    b, v, k = rules.shape
    n_in = v
    base, sel, clamped = sparse.xwin_selectors(rules, n_in)
    require(int(clamped) == 0, 'subm3: taps outside their window')
    gen = torch.Generator(device='cpu').manual_seed(3)
    feats = torch.randn((b, n_in + 1, 128), generator=gen).to(dev)
    feats[:, :n_in] *= in_mask[..., None]
    feats[:, n_in] = 0
    w32 = ((torch.rand((k, 128, 64), generator=gen) * 2 - 1)
           / (128 * k) ** 0.5).to(dev)
    live = in_mask.sum(1, dtype=torch.int32)
    mid = torch.minimum(live, torch.full_like(live, 64 * 29 + 17))
    stats = {}
    for dtype, tag in ((torch.float32, 'f32'), (torch.bfloat16, 'bf16')):
        table, w = feats.to(dtype), w32.to(dtype)
        for variant in ('xwin', 'seg'):
            fn = gx.gather_gemm_xwin if variant == 'xwin' else \
                gx.gather_gemm_seg
            plain = (gx.gather_gemm_xwin_plain if variant == 'xwin'
                     else gx.gather_gemm_seg_plain)
            err, scale = 0.0, 0.0
            for n_live in (live, mid, torch.zeros_like(live)):
                got = fn(table, base, sel, w, n_live)
                again = fn(table, base, sel, w, n_live)
                want = plain(table, base, sel, w, n_live)
                rows = gg.gather_gemm(table, rules, w, n_live)
                sync()
                require(torch.equal(got, again), '%s %s (128, 64): two '
                        'launches differ' % (variant, tag))
                require(torch.equal(got, rows), '%s %s (128, 64): not the '
                        'bits of kernel %s' % (variant, tag,
                                               'C' if tag == 'bf16' else 'B'))
                err = max(err, (got - want).abs().max().item())
                scale = max(scale, want.abs().max().item())
            require(err <= 1e-5 * scale, '%s %s (128, 64): kernel vs plain '
                    '%g > 1e-5 * %g' % (variant, tag, err, scale))
            ms = device_ms(lambda: fn(table, base, sel, w, live), 20)
            rows_ms = device_ms(lambda: gg.gather_gemm(table, rules, w,
                                                       live), 20)
            plain_ms = cuda_ms(lambda: plain(table, base, sel, w, live), 3, 1)
            name = 'gather_gemm_%s_%s' % (variant, tag)
            stats[name] = {'err': err, 'ms': ms, 'plain_ms': plain_ms,
                           'work': gather_work(
                               table, rules, live, 64, 8 * base.shape[2],
                               w.numel() * w.element_size()
                               + 4 * b * v * 64)}
            print('[parta2 R1] %s %s (128, 64) on the level-3 subm book (B=%d,'
                  ' V=%d, live %s, mid %s, 0): max |kernel - plain| %.3g (%.3g '
                  'of max |plain| %.4g); bitwise equal to kernel %s and to a '
                  'second launch; kernel %.4f ms (device), kernel %s %.4f ms, '
                  'plain %.4f ms, bound %.4f ms (%s); W stages %d, row stages '
                  '%d' % (variant, tag, b, v, live.tolist(), mid.tolist(),
                          err, err / scale, scale,
                          'C' if tag == 'bf16' else 'B', ms,
                          'C' if tag == 'bf16' else 'B', rows_ms, plain_ms,
                          *bound_ms(*stats[name]['work']),
                          *gx.stages(dtype, 128, 64)))
    return stats


def run_parta2(dev):
    """Phases R1-R3; returns the kernels line's entries of E and E' at
    (128, 64) and the launches by path of A and C: {name: {path: n}}."""
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.datasets.synthetic import (SyntheticDataset,
                                                    eval_batches)
    cfg = detect_mod.load_config(detect_mod.PARTA2_CFG)
    post = int(cfg.MODEL.TEST.NMS_POST_MAXSIZE_LAST)
    pts_np, mask_np = detect_mod.make_scans(cfg, 8, ring_keep=0.35)
    pts8 = torch.as_tensor(pts_np, device=dev)
    mask8 = torch.as_tensor(mask_np, device=dev)
    pts2, mask2 = pts8[:2].contiguous(), mask8[:2].contiguous()
    paths = {}

    # R1. PartA2.yaml at full width ---------------------------------------
    t_r1 = time.perf_counter()
    det = second_detector(cfg, dev)
    det.detect(pts2, mask2)                  # warm-up (cuDNN algorithms)
    sync()
    reset_launches()
    reset_overlap()
    preds = det.detect(pts2, mask2)
    sync()
    counts = nonzero(all_launches())
    a_launches, f_launches = overlap_launches()
    num = second_detect_checks(preds, post, 2)
    vox, ret, _, (f_prop, f_final) = parta2_run(det, pts2, mask2)
    rc = ret['rcnn']
    print('[parta2 R1] PartA2.yaml detect B2 (bf16 UNet, RPN and RCNN, loads '
          '%s): num %s; launches %s, kernel A %d, kernel F %d (proposal NMS '
          '%d, final NMS %d); input voxels %s of cap %d, voxelizer overflow '
          '%s; per-level drops %s, RoI pool points past the cap %d; RoIs %s, RoI labels %s'
          % (tuple(det.loads), num, counts, a_launches, f_launches, f_prop,
             f_final,
             vox['voxel_mask'].sum(1).tolist(), det.max_voxels,
             voxel_overflow(det, pts2, mask2),
             {k: v.tolist() for k, v in ret['overflow'].items()
              if k != 'roi_pts'}, int(ret['overflow']['roi_pts']),
             rc['roi_valid'].sum(1).tolist(),
             torch.bincount(rc['roi_labels'][rc['roi_valid']].flatten(),
                            minlength=4).tolist()[1:]))
    require(counts == parta2_launches(det.loads, torch.bfloat16),
            'launches %s, want %s' % (counts, parta2_launches(
                det.loads, torch.bfloat16)))
    require(f_prop > 0 and f_final > 0 and f_launches == f_prop + f_final
            and a_launches == 0, 'kernel A %d launches, kernel F %d: '
            'proposal NMS %d, final NMS %d'
            % (a_launches, f_launches, f_prop, f_final))
    require(bool(rc['roi_valid'].all()), 'fewer than NMS_POST_MAXSIZE RoIs')
    paths['rotated_overlap'] = {'parta2 detect B2': a_launches}
    paths['nms_fused'] = {'parta2 detect B2': f_launches}
    paths['gather_gemm_bf16'] = {'parta2 detect B2':
                                 counts['gather_gemm_bf16']}
    parta2_pool_repeat('R1', det, vox, ret)
    gpu32, ref32 = parta2_gpu_vs_cpu('R1', cfg, dev, pts2, mask2)
    del gpu32
    pairs = parta2_loads('R1', cfg, dev, pts2, mask2, preds, torch.bfloat16)
    pairs.update(parta2_loads('R1', parta2_f32(cfg), dev, pts2, mask2, ref32,
                              torch.float32))
    stats = window_pair_vs_plain(dev, vox['books'])
    parta2_times('R1', det, pts8, mask8, (2, 8), profile=True)
    del det, vox, ret
    sync()
    print('[parta2 R1] %.1f s' % (time.perf_counter() - t_r1))

    # R2. PartA2_fc.yaml at B2 --------------------------------------------
    t0 = time.perf_counter()
    cfg_fc = detect_mod.load_config(detect_mod.PARTA2_FC_CFG)
    det = second_detector(cfg_fc, dev)
    det.detect(pts2, mask2)
    sync()
    reset_launches()
    reset_overlap()
    preds = det.detect(pts2, mask2)
    sync()
    counts = nonzero(all_launches())
    a_launches, f_launches = overlap_launches()
    num = second_detect_checks(preds, post, 2)
    vox, ret, _, (f_prop, f_final) = parta2_run(det, pts2, mask2)
    print('[parta2 R2] PartA2_fc.yaml detect B2 (FCRCNN on 12^3 grids): num '
          '%s; launches %s, kernel A %d, kernel F %d (proposal NMS %d, final '
          'NMS %d); RoI pool points past the cap %d' % (
              num, counts, a_launches, f_launches, f_prop, f_final,
              int(ret['overflow']['roi_pts'])))
    require(counts == parta2_launches(det.loads, torch.bfloat16),
            'launches %s' % counts)
    require(f_prop > 0 and f_final > 0, 'kernel F did not run both NMS')
    paths['rotated_overlap']['parta2_fc detect B2'] = a_launches
    paths['nms_fused']['parta2_fc detect B2'] = f_launches
    paths['gather_gemm_bf16']['parta2_fc detect B2'] = counts[
        'gather_gemm_bf16']
    parta2_pool_repeat('R2', det, vox, ret)
    parta2_gpu_vs_cpu('R2', cfg_fc, dev, pts2, mask2)
    parta2_loads('R2', cfg_fc, dev, pts2, mask2, preds, torch.bfloat16)
    parta2_times('R2', det, pts8, mask8, (2,))
    del det, vox, ret
    sync()
    print('[parta2 R2] %.1f s' % (time.perf_counter() - t0))

    # R3. eval_one_epoch on 16 synthetic scenes at B2 and B8 --------------
    t0 = time.perf_counter()
    cfg_e = eval_config(detect_mod.PARTA2_CFG)
    det = eval_detector(cfg_e, dev)
    dataset = SyntheticDataset(cfg_e)
    for b in (2, 8):
        batches = list(eval_batches(dataset, b))
        det.detect(torch.as_tensor(batches[0]['points'], device=dev),
                   torch.as_tensor(batches[0]['point_mask'], device=dev))
        result, checker, counts = run_eval_checked(det, dataset, batches,
                                                   cfg_e)
        eval_checks('PartA2.yaml B%d' % b, result, checker, counts)
        cross_checks('PartA2.yaml B%d' % b, checker)
        require(counts.get('gather_gemm_bf16', 0) == PARTA2_CONVS
                * len(batches), 'the Part-A2 eval launched C %s times'
                % counts.get('gather_gemm_bf16'))
        paths['rotated_overlap']['parta2 eval B%d (R3)' % b] = counts[
            'rotated_overlap']
        paths['nms_fused']['parta2 eval B%d (R3)' % b] = counts['nms_fused']
        if b == 2:
            oracle_check(dev, dataset, batches, cfg_e)
        splits = [eval_split(det, dataset, batches, cfg_e)[0]
                  for _ in range(3)]
        med = {k: sorted(x[k] for x in splits)[1] for k in splits[0]}
        print('[parta2 R3 B%d] eval loop %.2f frames/s without the evaluator '
              '(eval_one_epoch\'s sec_per_example %.4f), %.2f with it (the '
              'split\'s sum); split over %d frames (host clock, median of 3): '
              'detect %.1f ms (%.2f frames/s), recall %.1f ms, annotate %.1f '
              'ms, evaluate %.1f ms' % (
                  b, 1.0 / result['sec_per_example'],
                  result['sec_per_example'], len(dataset) / sum(med.values()),
                  len(dataset),
                  1e3 * med['detect'], len(dataset) / med['detect'],
                  1e3 * med['recall'], 1e3 * med['annotate'],
                  1e3 * med['evaluate']))
    del det
    sync()
    print('[parta2 R3] %.1f s' % (time.perf_counter() - t0))

    entries = []
    for name, st in stats.items():
        entry = kernel_entry(name + '@128x64', GEMM_SRC,
                             REPLACES[name.rsplit('_', 1)[0]],
                             pairs.get(name, 0), st['err'], st['ms'],
                             st['plain_ms'], st['work'])
        entry['launches_by_path'] = {'parta2 detect B2 under loads.fwd %s'
                                     % name.split('_')[2]: pairs.get(name, 0)}
        require(entry['launches'] > 0, '%s at (128, 64): no launch' % name)
        entries.append(entry)
    return entries, paths


# ----------------------------------------------------------------------------
# R5-R7: Part-A² and Part-A²-fc training
# ----------------------------------------------------------------------------

# the sparse-conv launches of one Part-A² train step under the default loads
# (rows, seg): 28 forward convs and 27 feature gradients (not conv_input's)
# on B, conv_out's dW on D, the 27 kw=3 convs' dW on D'; the selectors of
# the 7 kw=3 books and of the 3 inverse convs' books, for D'
PARTA2_TRAIN_LAUNCHES = {'gather_gemm_f32': PARTA2_CONVS,
                         'gather_gemm_f32_dgrad': PARTA2_CONVS - 1,
                         'gather_dw': 1, 'gather_dw_seg': PARTA2_CONVS - 1,
                         'xwin_selectors': 10}
# the decoder's pairs of the new dW instances, each on a subm book of its
# level (conv_up_m1 / m2 / m3's), and E / E' (64, 128), up3_m's feature
# gradient
DECODER_PAIRS = ((32, 16, 'subm1'), (64, 32, 'subm2'), (128, 64, 'subm3'))
PARTA2_LOSS_TERMS = ('rpn_loss_u_cls', 'rpn_u_loss_reg', 'rpn_loss_cls',
                     'rpn_loss_loc', 'rpn_loss_dir', 'rcnn_loss_cls',
                     'rcnn_loss_reg', 'rcnn_loss_corner')


def parta2_gt_proposals(model, gt_boxes, per=4):
    """Wrap `model.proposals` so that, in each sample, the proposal layer's
    last `per` RoI slots (its lowest scores) become the sample's first GT
    boxes (`gt_boxes` (B, M, 8) on the device), each moved by 0.1 m along x
    and grown by 5%, with its class, valid.  On random weights the
    proposals lie where the scans' boxes are not (RoI-GT IoU 1e-3 at most)
    and move with every step; with these RoIs the sampler finds foreground
    in every step, so the regression and corner losses and their
    gradients run.  The layer itself runs as ever; `rec['raw']` keeps its
    output and `rec['roi']` what the model was given.  Returns rec."""
    rec = {}
    inner = model.proposals
    gt = gt_boxes.detach()
    n_gt = (gt[..., 3] > 0).sum(1, keepdim=True).clamp(min=1)
    idx = torch.arange(per, device=gt.device)[None] % n_gt
    take = torch.gather(gt, 1, idx[..., None].expand(-1, -1, gt.shape[-1]))
    grow = torch.tensor([1, 1, 1, 1.05, 1.05, 1.05, 1], device=gt.device)
    shift = torch.tensor([0.1, 0, 0, 0, 0, 0, 0], device=gt.device)
    boxes = take[..., :7] * grow + shift

    def proposals(*args, **kw):
        rec['raw'] = roi = inner(*args, **kw)
        out = {k: v.clone() for k, v in roi.items()}
        out['rois'][:, -per:] = boxes.to(out['rois'].dtype)
        out['roi_labels'][:, -per:] = take[..., 7].to(out['roi_labels'].dtype)
        out['roi_valid'][:, -per:] = True
        rec['roi'] = out
        return out
    model.proposals = proposals
    return rec


def parta2_fg_checks(tag, tbs, samplers):
    """Every step took foreground RoIs in every sample and its regression
    and corner losses on them."""
    for i, (tb, s) in enumerate(zip(tbs, samplers)):
        require(min(s['fg_count']) > 0 and tb['rcnn_loss_reg'] > 0
                and tb['rcnn_loss_corner'] > 0, '%s step %d: fg RoIs taken '
                '%s, rcnn_loss_reg %g, rcnn_loss_corner %g' % (
                    tag, i + 1, s['fg_count'], tb['rcnn_loss_reg'],
                    tb['rcnn_loss_corner']))


def parta2_train_steps(tag, trainer, batch, steps):
    """`steps` steps on one batch from launch counts set to 0: every loss
    term finite, the last loss below the first, foreground RoIs and a
    regression and corner loss on them in every step (`parta2_fg_checks`);
    the sampler's counts and kernel A's launches per step (proposal NMS
    rounds, the sampler's IoU).
    Returns (losses, sparse-conv launches, A launches over the steps)."""
    from pcdet_tpu_torch.models import parta2 as pa
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_xwin as gx
    model = trainer.model
    had, real = 'proposals' in vars(model), model.proposals
    prop = []

    def proposals(*args, **kw):
        n = overlap_launches()[1]
        out = real(*args, **kw)
        prop.append(overlap_launches()[1] - n)
        return out
    model.proposals = proposals
    sync()
    reset_launches()
    gd.PAIR_LAUNCHES.clear()
    gx.PAIR_LAUNCHES.clear()
    reset_overlap()
    tbs, samplers = [], []
    t0 = time.perf_counter()
    try:
        for _ in range(steps):
            tbs.append({k: float(v) for k, v in trainer.step(batch).items()})
            samplers.append({k: v.tolist() for k, v in
                             model.last_sampler.items() if k != 'picks'})
    finally:
        if had:
            model.proposals = real
        else:
            del model.proposals
    sync()
    wall = time.perf_counter() - t0
    counts = nonzero(all_launches())
    a_total, f_total = overlap_launches()
    losses = [tb['loss'] for tb in tbs]
    print('%s %d steps on one batch in %.2f s: loss %s' % (
        tag, steps, wall, ', '.join('%.5f' % x for x in losses)))
    for i, (tb, s) in enumerate(zip(tbs, samplers)):
        print('%s step %d: %s; overflow %s; sampler fg / hard bg / easy bg '
              '%s / %s / %s, fg_count %s, hard_num %s' % (
                  tag, i + 1, ', '.join('%s %.5f' % (k, tb[k])
                                        for k in PARTA2_LOSS_TERMS),
                  {k[9:]: int(v) for k, v in tb.items()
                   if k.startswith('overflow/')}, s['n_fg'], s['n_hard'],
                  s['n_easy'], s['fg_count'], s['hard_num']))
    print('%s launches over %d steps %s; kernel A %d (the sampler\'s IoU, 1 '
          'a step); kernel F %d (the proposal NMS), per step %s; dW launches '
          'by (kernel, Cin, Cout) %s; E / E\' by pair %s' % (
              tag, steps, counts, a_total, f_total, prop, dict(sorted(
                  gd.PAIR_LAUNCHES.items())), dict(sorted(
                      gx.PAIR_LAUNCHES.items()))))
    require(all(np.isfinite(tb[k]) for tb in tbs for k in PARTA2_LOSS_TERMS
                + ('loss',)), '%s a non-finite loss term' % tag)
    require(losses[-1] < losses[0], '%s loss did not fall in %d steps: %s'
            % (tag, steps, losses))
    require(all(n > 0 for n in prop) and f_total == sum(prop)
            and a_total == steps, '%s kernel A: %d launches, kernel F %d, '
            'a step %s' % (tag, a_total, f_total, prop))
    require('overflow/roi_pts' in tbs[0], '%s no overflow/roi_pts' % tag)
    parta2_fg_checks(tag, tbs, samplers)
    return losses, counts, (a_total, f_total), dict(gd.PAIR_LAUNCHES)


def parta2_record(model):
    """Keep the proposals of `model`'s next forwards (in `rec['roi']`) and
    the head outputs they came from (`rec['heads']`)."""
    rec = {}
    real = model.proposals

    def proposals(ret, *args, **kw):
        rec['heads'] = {k: ret[k].detach() for k in (
            'cls_preds', 'box_preds', 'dir_cls_preds')}
        rec['roi'] = real(ret, *args, **kw)
        return rec['roi']
    model.proposals = proposals
    return rec


def parta2_inject(model, src, dev, dtype, proposals=True):
    """Give `model` another run's sampler picks, dropout masks and (with
    `proposals`) proposals, on `dev`, floats in `dtype`."""
    if proposals:
        roi = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
               for k, v in src['roi'].items()}
        model.proposals = lambda ret, train=False: roi
    model.fixed_picks = src['picks'].to(dev)
    for d, m in zip(model.dropouts(), src['masks']):
        d.fixed_mask = m.to(dev)


def parta2_to(trainer, dtype):
    """The trainer's model and the wrapper's own tensors (those it has of
    anchors, voxel_size, pc_origin) in `dtype`."""
    model = trainer.model
    model.module.to(dtype)
    for attr in ('anchors', 'voxel_size', 'pc_origin'):
        if torch.is_tensor(getattr(model, attr, None)):
            setattr(model, attr, getattr(model, attr).to(dtype))


def parta2_four_ways(tag, cfg, dev, pts, mask, gt):
    """R6: one B1 step from the same seeded weights: K32 the card through
    the kernels, C32 the CPU, P64 the card through the kernels' plain
    versions in f64, C64 the CPU in f64.  C32, P64 and C64 take K32's
    proposals (kernel A is f32 only), sampler picks and dropout masks; the
    f64 runs take the sampler's IoU in f64 through kernel A's plain version
    on both devices.  The proposals are compared on their own: the CPU's
    proposal layer on K32's head outputs against K32's (validity and labels
    equal, each box within 1e-5 of its largest |coordinate|, at least 1
    m); C32's own, from its own head outputs, are printed beside them (at
    pre 9000 the two devices' f32 logits, some 1e-4 apart, order
    near-equal candidates apart).  K32's last 4 RoI slots a sample are GT
    boxes, moved and grown (`parta2_gt_proposals`), and so are those the
    other runs take: every run takes fg RoIs and a regression and corner
    loss, and a gradient reaches the RCNN's regression layer.
    Requires the f32 losses within 1e-4 relative, the f64 loss and every
    f64 gradient within 1e-9; prints the per-module errors.  Returns K32's
    trainer, batch and record."""
    from pcdet_tpu_torch.train import train_state
    from pcdet_tpu_torch.train.trainer import build_trainer
    out, src, keep = {}, {}, None
    for name, d, dtype in (('K32', dev, torch.float32),
                           ('C32', torch.device('cpu'), torch.float32),
                           ('P64', dev, torch.float64),
                           ('C64', torch.device('cpu'), torch.float64)):
        tr = build_trainer(cfg, d, seed=0, total_steps=10)
        parta2_to(tr, dtype)
        model = tr.model
        t0 = time.perf_counter()
        b1 = tr.make_batch(pts.to(d), mask.to(d), gt)
        b1 = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
              else v for k, v in b1.items()}
        rec = parta2_record(model)
        if name == 'K32':
            given = parta2_gt_proposals(model, b1['gt_boxes'])
        else:
            parta2_inject(model, src, d, dtype)
        if name == 'C32':
            model.proposals = parta2_also_own(model, rec)
        # f64 through the plain versions (kernel A, which the sampler's IoU
        # runs, takes f32 only; on the CPU the sparse convs are plain anyway)
        with plain_sparse(dtype == torch.float64):
            loss, tb, grads = train_state.loss_and_grads(model,
                                                         tr.state.params, b1)
        tb = {k: float(v) for k, v in tb.items()}
        sampler = {k: v.tolist() for k, v in model.last_sampler.items()
                   if k != 'picks'}
        print('%s %s: fg RoIs taken %s (of fg %s, hard bg %s, easy bg %s), '
              'rcnn_loss_reg %.7g, rcnn_loss_corner %.7g' % (
                  tag, name, sampler['fg_count'], sampler['n_fg'],
                  sampler['n_hard'], sampler['n_easy'], tb['rcnn_loss_reg'],
                  tb['rcnn_loss_corner']))
        parta2_fg_checks('%s %s' % (tag, name), [tb], [sampler])
        if name == 'K32':
            src = {'roi': {k: v.detach().cpu() for k, v in
                           given['roi'].items()},
                   'raw': {k: v.detach().cpu() for k, v in
                           rec['roi'].items()},
                   'heads': rec['heads'],
                   'picks': model.last_sampler['picks'].cpu(),
                   'masks': [m.last_mask.cpu() for m in model.dropouts()]}
            keep = (tr, b1, src)
        if name == 'C32':
            from pcdet_tpu_torch.models.parta2 import PartA2Net
            with torch.no_grad():
                cross = PartA2Net.proposals(model, {
                    k: v.cpu() for k, v in src['heads'].items()}, True)
            want = src['raw']
            diff = (cross['rois'] - want['rois']).abs()
            # each box's error against its own magnitude (at least 1 m): on
            # random weights some boxes decode to 1e4 m, where one f32 ulp
            # is 1e-3
            scale = want['rois'].abs().amax(-1, keepdim=True).clamp(min=1.0)
            rel = (diff / scale).max().item()
            at = int(diff.flatten().argmax())
            print('%s the CPU\'s proposal layer on K32\'s head outputs vs '
                  'K32\'s proposals: valid equal %s, labels equal %s, max |box '
                  'diff| %.3g (at a box of max |coordinate| %.4g), max |box '
                  'diff| / max(max |box coordinate|, 1 m) %.3g (bound 1e-5), '
                  'max |raw score diff| %.3g' % (
                      tag, torch.equal(cross['roi_valid'], want['roi_valid']),
                      torch.equal(cross['roi_labels'], want['roi_labels']),
                      diff.max().item(),
                      scale.expand_as(diff).flatten()[at].item(), rel,
                      (cross['roi_raw_scores'] - want['roi_raw_scores'])
                      .abs().max().item()))
            require(torch.equal(cross['roi_valid'], want['roi_valid'])
                    and torch.equal(cross['roi_labels'], want['roi_labels'])
                    and rel <= 1e-5, '%s the proposal layer differs between '
                    'the card and the CPU' % tag)
            got = rec['own']
            slot = (got['rois'] - want['rois']).abs().amax(-1)
            near = (got['rois'][:, :, None] - want['rois'][:, None]).abs(
            ).amax(-1).amin(-1)
            score = (got['roi_raw_scores'] - want['roi_raw_scores']).abs()
            print('%s C32\'s own proposals vs K32\'s: valid equal %s, labels '
                  'equal %s; slots whose box differs by > 1e-3: %d of %d '
                  '(raw score gaps there %s); every RoI within %.3g of one '
                  'of the other\'s; max |raw score diff| %.3g' % (
                      tag, torch.equal(got['roi_valid'], want['roi_valid']),
                      torch.equal(got['roi_labels'], want['roi_labels']),
                      int((slot > 1e-3).sum()), slot.numel(),
                      score[slot > 1e-3].tolist()[:8],
                      near.max().item(), score.max().item()))

        mnames = [n for n, _ in model.module.named_parameters()]
        out[name] = (float(loss), {n: g.detach().cpu().double()
                                   for n, g in zip(mnames, grads)})
        print('%s %s train step B1: %.2f s' % (tag, name,
                                               time.perf_counter() - t0))
        if name != 'K32':
            del tr
        del b1, grads
    rel32 = abs(out['K32'][0] - out['C32'][0]) / abs(out['C32'][0])
    rel64 = abs(out['P64'][0] - out['C64'][0]) / abs(out['C64'][0])
    print('%s loss K32 %.7f, C32 %.7f (rel %.3g); P64 %.12f, C64 %.12f (rel '
          '%.3g)' % (tag, out['K32'][0], out['C32'][0], rel32,
                     out['P64'][0], out['C64'][0], rel64))
    ref = out['C64'][1]
    groups = {n: '.'.join(n.split('.')[:2]) for n in ref}
    worst64 = 0.0
    for a, b in (('K32', 'C32'), ('K32', 'C64'), ('C32', 'C64'),
                 ('P64', 'C64')):
        per = {}
        for n, r in ref.items():
            e = ((out[a][1][n] - out[b][1][n]).abs().max().item()
                 / max(r.abs().max().item(), 1e-30))
            per[groups[n]] = max(per.get(groups[n], 0.0), e)
        if a == 'P64':
            worst64 = max(per.values())
        print('%s gradient %s vs %s, largest error / max |grad| per module: '
              '%s' % (tag, a, b, ', '.join('%s %.2e' % x
                                           for x in sorted(per.items()))))
    reg = {a: max(g.abs().max().item() for n, g in out[a][1].items()
                  if n.startswith('rcnn_net.reg_layer.'))
           for a in out}
    print('%s max |grad| of rcnn_net.reg_layer: %s' % (
        tag, ', '.join('%s %.4g' % kv for kv in reg.items())))
    require(min(reg.values()) > 0, '%s no gradient reaches the RCNN\'s '
            'regression layer' % tag)
    require(rel32 <= 1e-4, '%s GPU vs CPU f32 loss %g relative' % (tag, rel32))
    require(rel64 <= 1e-9 and worst64 <= 1e-9, '%s GPU vs CPU f64: loss %g '
            'relative, gradients %g of max' % (tag, rel64, worst64))
    return keep


def parta2_also_own(model, rec):
    """`model`'s proposals as given (`model.proposals`), with its own
    computed beside them into `rec['own']`."""
    import types
    from pcdet_tpu_torch.models.parta2 import PartA2Net
    given, own = model.proposals, types.MethodType(PartA2Net.proposals,
                                                   model)

    def proposals(*args, **kw):
        rec['own'] = {k: v.detach() for k, v in own(*args, **kw).items()}
        return given(*args, **kw)
    return proposals


def decoder_pairs_vs_plain(dev, batch):
    """The new instances on a real B1 train batch's books: D, D'' and D' at
    the decoder's (32, 16), (64, 32), (128, 64) on the subm book of each
    pair's level (the UR blocks' merge convs), n_live real, mid-tile and 0,
    within 1e-4 of max |plain|, two launches bitwise equal; E and E' f32 at
    (64, 128) (up3_m's feature gradient) on the level-3 subm book within
    1e-5 of max |plain|, bitwise equal to kernel B and to a second launch.
    Device times, plain times, bounds.  Returns {entry name: stats}."""
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    books = batch['books']
    masks = {'subm1': batch['voxel_mask'], 'subm2': books['spconv2'][2],
             'subm3': books['spconv3'][2]}
    gen = torch.Generator(device='cpu').manual_seed(5)
    stats = {}
    cases = [(cin, cout, key, 'dw') for cin, cout, key in DECODER_PAIRS]
    cases.append((64, 128, 'subm3', 'gemm'))
    for cin, cout, key, what in cases:
        rules, mask = books[key], masks[key]
        b, v, k = rules.shape
        base, sel, clamped = sparse.xwin_selectors(rules, v)
        require(int(clamped) == 0, '%s: taps outside their window' % key)
        table = torch.randn((b, v + 1, cin), generator=gen).to(dev)
        table[:, :v] *= mask[..., None]
        table[:, v] = 0
        live = mask.sum(1, dtype=torch.int32)
        mid = torch.minimum(live, torch.full_like(live, 64 * 7 + 23))
        if what == 'dw':
            g = torch.randn((b, v, cout), generator=gen).to(dev)
            g *= mask[..., None]
            variants = (('gather_dw', lambda n: gd.gather_dw(
                            table, rules, g, n),
                         lambda n: gd.gather_dw_plain(table, rules, g, n),
                         4 * k, 1e-4),
                        ('gather_dw_xwin', lambda n: gd.gather_dw_xwin(
                            table, base, sel, g, n),
                         lambda n: gd.gather_dw_xwin_plain(table, base, sel,
                                                           g, n),
                         8 * base.shape[2], 1e-4),
                        ('gather_dw_seg', lambda n: gd.gather_dw_seg(
                            table, base, sel, g, n),
                         lambda n: gd.gather_dw_seg_plain(table, base, sel,
                                                          g, n),
                         8 * base.shape[2], 1e-4))
            tail = 4 * (b * v * cout + k * cin * cout)
        else:
            w = ((torch.rand((k, cin, cout), generator=gen) * 2 - 1)
                 / (cin * k) ** 0.5).to(dev)
            variants = (('gather_gemm_xwin_f32', lambda n: gx.gather_gemm_xwin(
                            table, base, sel, w, n),
                         lambda n: gx.gather_gemm_xwin_plain(table, base, sel,
                                                             w, n),
                         8 * base.shape[2], 1e-5),
                        ('gather_gemm_seg_f32', lambda n: gx.gather_gemm_seg(
                            table, base, sel, w, n),
                         lambda n: gx.gather_gemm_seg_plain(table, base, sel,
                                                            w, n),
                         8 * base.shape[2], 1e-5))
            tail = 4 * (k * cin * cout + b * v * cout)
        for name, fn, plain, index_bytes, tol in variants:
            err, scale = 0.0, 0.0
            for n_live in (live, mid, torch.zeros_like(live)):
                got, again, want = fn(n_live), fn(n_live), plain(n_live)
                sync()
                require(torch.equal(got, again), '%s (%d, %d): two launches '
                        'differ' % (name, cin, cout))
                if what == 'gemm':
                    require(torch.equal(got, gg.gather_gemm(table, rules, w,
                                                            n_live)),
                            '%s (%d, %d): not the bits of kernel B'
                            % (name, cin, cout))
                err = max(err, (got - want).abs().max().item())
                scale = max(scale, want.abs().max().item())
            require(err <= tol * scale, '%s (%d, %d): kernel vs plain %g > '
                    '%g * %g' % (name, cin, cout, err, tol, scale))
            ms = device_ms(lambda: fn(live), 20)
            plain_ms = cuda_ms(lambda: plain(live), 3, 1)
            work = gather_work(table, rules, live, cout, index_bytes, tail)
            entry = '%s@%dx%d' % (name, cin, cout)
            stats[entry] = {'name': name, 'err': err, 'ms': ms,
                            'plain_ms': plain_ms, 'work': work}
            print('[parta2 R6] %s (%d, %d) on the %s book of a B1 train batch '
                  '(V=%d, live %s, mid %s, 0): max |kernel - plain| %.3g '
                  '(%.3g of max |plain| %.4g), two launches equal%s; kernel '
                  '%.4f ms (device), plain %.4f ms, bound %.4f ms (%s)%s' % (
                      name, cin, cout, key, v, live.tolist(), mid.tolist(),
                      err, err / scale, scale,
                      ', bitwise equal to kernel B' if what == 'gemm' else '',
                      ms, plain_ms, *bound_ms(*work),
                      '; row stages %d' % gd.row_stages(cin, cout)
                      if what == 'dw' else '; W / row stages %d / %d'
                      % gx.stages(torch.float32, cin, cout)))
    return stats


def parta2_window_steps(cfg, dev, pts, mask, gt, src):
    """R6: one B1 step under rows (rows, rows), (seg, seg) and (xwin, xwin)
    with K32's proposals, picks and masks: each window step's loss within
    1e-5 relative and its sparse convs' dW within 1e-3 of max |dW| of the
    rows step's, no tap outside its window.  Returns the launches of each
    step by (kernel, Cin, Cout)."""
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import sparse
    from pcdet_tpu_torch.train import train_state
    from pcdet_tpu_torch.train.trainer import build_trainer
    real_selectors = sparse.xwin_selectors
    clamped = []

    def selectors(*args, **kw):
        out = real_selectors(*args, **kw)
        clamped.append(int(out[2]))
        return out
    res, pairs = {}, {}
    for loads in (sparse.ROWS, sparse.Loads('seg', 'seg'),
                  sparse.Loads('xwin', 'xwin')):
        tr = build_trainer(cfg, dev, seed=0, total_steps=10, loads=loads)
        b1 = tr.make_batch(pts, mask, gt)
        parta2_inject(tr.model, src, dev, torch.float32)
        sparse.xwin_selectors = selectors
        clamped.clear()
        try:
            sync()
            reset_launches()
            gd.PAIR_LAUNCHES.clear()
            gx.PAIR_LAUNCHES.clear()
            loss, _, grads = train_state.loss_and_grads(
                tr.model, tr.state.params, b1)
            sync()
        finally:
            sparse.xwin_selectors = real_selectors
        counts = nonzero(all_launches())
        pairs[tuple(loads)] = {**gd.PAIR_LAUNCHES, **gx.PAIR_LAUNCHES}
        names = [n for n, _ in tr.model.module.named_parameters()]
        res[tuple(loads)] = (float(loss), {
            n: g for n, g in zip(names, grads) if n.startswith('rpn_net.')
            and ('conv' in n) and n.endswith('weight') and g.dim() == 5})
        print('[parta2 R6] B1 step under loads %s: loss %.7f; launches %s; '
              'selector builds %d, taps outside their window %d' % (
                  tuple(loads), float(loss), counts, len(clamped),
                  sum(clamped)))
        require(sum(clamped) == 0, 'loads %s: taps outside their window'
                % (tuple(loads),))
        del tr, b1, grads
    rows_loss, rows_dw = res[('rows', 'rows')]
    for loads in (('seg', 'seg'), ('xwin', 'xwin')):
        loss, dw = res[loads]
        worst = max((dw[n] - rows_dw[n]).abs().max().item()
                    / rows_dw[n].abs().max().item() for n in rows_dw)
        rel = abs(loss - rows_loss) / abs(rows_loss)
        print('[parta2 R6] loads %s vs rows: loss rel %.3g, sparse convs\' dW '
              'largest error / max |dW| %.3g over %d convs' % (
                  loads, rel, worst, len(dw)))
        require(rel <= 1e-5 and worst <= 1e-3, 'loads %s: loss %g, dW %g '
                'from the rows step' % (loads, rel, worst))
    return pairs


def parta2_host_stages(trainer, points, mask, gt, iters=3):
    """Median ms of the stages of `Trainer.make_batch` itself, each callee
    timed where make_batch calls it (host clock, the card synchronised at
    each callee's end): voxelize, the coords' copy to the host (from
    voxelize's end to the books' start), the host books, the anchor
    targets, the model's host targets (Part-A²'s GT and part targets), the
    upload, the books' decode, and the whole call."""
    from pcdet_tpu_torch.ops import host_books
    model = trainer.model
    marks = {}

    def wrap(obj, attr, name):
        real = getattr(obj, attr)

        def call(*args, **kw):
            marks[name] = time.perf_counter()
            out = real(*args, **kw)
            sync()
            marks[name + ' end'] = time.perf_counter()
            return out
        setattr(obj, attr, call)
    patched = ((trainer, 'voxelize', 'voxelize'),
               (model, 'build_books', 'books'),
               (trainer, 'targets', 'anchor targets'),
               (model, 'host_targets', 'part targets'),
               (host_books, 'upload', 'upload'),
               (host_books, 'decode_books', 'decode'))
    own = [(obj, attr, attr in vars(obj), getattr(obj, attr))
           for obj, attr, _ in patched]
    for obj, attr, name in patched:
        wrap(obj, attr, name)
    t = {}
    try:
        for _ in range(iters):
            marks.clear()
            sync()
            t0 = time.perf_counter()
            trainer.make_batch(points, mask, gt)
            sync()
            marks['make_batch end'] = time.perf_counter()
            marks['make_batch'] = t0
            marks['d2h'] = marks['voxelize end']
            marks['d2h end'] = marks['books']
            for key in ('voxelize', 'd2h', 'books', 'anchor targets',
                        'part targets', 'upload', 'decode', 'make_batch'):
                t.setdefault(key, []).append(
                    1e3 * (marks[key + ' end'] - marks[key]))
    finally:
        for obj, attr, was_own, real in own:
            if was_own:
                setattr(obj, attr, real)
            else:
                delattr(obj, attr)
    return {k: sorted(v)[len(v) // 2] for k, v in t.items()}


def parta2_step_split(trainer, batch, iters=3):
    """Median ms of a prebuilt step's parts by CUDA events recorded on the
    stream around each stage: stage 1 (VFE, UNet, RPN), the proposal layer
    (its NMS rounds), the target layer (sampler), the pool, the RCNN, the
    loss, the backward, the optimizer."""
    from pcdet_tpu_torch.models import parta2 as pa
    model, state = trainer.model, trainer.state
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    def wrap(obj, attr, name):
        real = getattr(obj, attr)

        def call(*args, **kw):
            mark(name)
            out = real(*args, **kw)
            mark(name + ' end')
            return out
        setattr(obj, attr, call)
    rcnn = model.module.rcnn_net
    patched = ((model, 'proposals', 'proposal'),
               (pa, 'proposal_target_layer', 'targets'),
               (model, 'pool', 'pool'), (rcnn, 'forward', 'rcnn'))
    own = [(obj, attr, attr in vars(obj), getattr(obj, attr))
           for obj, attr, _ in patched]
    for obj, attr, name in patched:
        wrap(obj, attr, name)
    parts = {}
    try:
        for _ in range(iters):
            marks.clear()
            mark('start')
            model.train_mode()
            ret = model.forward(batch)
            mark('rcnn out')
            loss, _ = model.loss(ret, batch)
            mark('loss')
            grads = torch.autograd.grad(loss, state.params)
            mark('backward')
            state.optimizer.step(grads)
            mark('optimizer')
            sync()
            ev = dict(marks)
            for key, a, b in (('stage 1', 'start', 'proposal'),
                              ('proposal', 'proposal', 'proposal end'),
                              ('targets', 'targets', 'targets end'),
                              ('pool', 'pool', 'pool end'),
                              ('rcnn', 'rcnn', 'rcnn end'),
                              ('loss', 'rcnn out', 'loss'),
                              ('backward', 'loss', 'backward'),
                              ('optimizer', 'backward', 'optimizer')):
                parts.setdefault(key, []).append(ev[a].elapsed_time(ev[b]))
    finally:
        for obj, attr, was_own, real in own:
            if was_own:
                setattr(obj, attr, real)
            else:
                delattr(obj, attr)
    return {k: sorted(v)[len(v) // 2] for k, v in parts.items()}


def parta2_train_times(tag, trainer, pts8, mask8, gts, steps=1,
                       profile=False):
    """R7: ms per step and samples/s at each batch size of `gts` ({B: gt
    boxes}), the batch built and prebuilt (median of 3 runs of `steps`),
    the host stages and the step's split; at the largest batch a
    torch.profiler list of the top kernels and the idle share."""
    batches = sorted(gts)
    for b in batches:
        pts, mask, gt = pts8[:b].contiguous(), mask8[:b].contiguous(), gts[b]
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
        host = parta2_host_stages(trainer, pts, mask, gt)
        split = parta2_step_split(trainer, batch)
        print('%s B%d step with the batch built: %.2f ms (%.2f samples/s; %s);'
              ' prebuilt: %.2f ms (%.2f samples/s; %s); median of 3 runs of %d'
              ' steps' % (tag, b, ms_full, 1e3 * b / ms_full,
                          ', '.join('%.2f' % x for x in full), ms_pre,
                          1e3 * b / ms_pre, ', '.join('%.2f' % x for x in pre),
                          steps))
        print('%s B%d host: %s; device: %s (ms)' % (
            tag, b, ', '.join('%s %.2f' % kv for kv in host.items()),
            ', '.join('%s %.2f' % kv for kv in split.items())))
        if not profile or b != max(batches):
            continue
        busy, rows = profile_train(trainer, batch, iters=1)
        if not rows:
            print('%s B%d no device time recorded: not measured' % (tag, b))
            continue
        idle = ('idle %.1f%% of the prebuilt step, %.1f%% of the step with '
                'the batch built' % (100 * (1 - busy / ms_pre),
                                     100 * (1 - busy / ms_full))
                if busy <= ms_pre else 'idle not measured (busy under the '
                'profiler exceeds the unprofiled prebuilt step)')
        sparse_ms = sum(t for t, n in rows if 'gather_' in n
                        or 'sum_partials' in n or 'xwin_selectors' in n)
        print('%s B%d device busy %.2f ms per step: %s; sparse-conv kernels '
              '%.3f ms (%.1f%%); %d kernel names' % (
                  tag, b, busy, idle, sparse_ms, 100 * sparse_ms / busy,
                  len(rows)))
        for t, name in rows[:12]:
            print('%s B%d   kernel %8.3f ms %5.1f%%  %s' % (
                tag, b, t, 100 * t / busy, name[:90]))


def run_parta2_train(dev):
    """Phases R5-R7; returns the kernels line's entries of the new
    instances and the launches by path {name: {path: n}}."""
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans
    cfg = detect_mod.load_config(detect_mod.PARTA2_CFG)
    pts_np, mask_np, gt_np = make_train_scans(cfg, 8, ring_keep=0.35)
    pts8 = torch.as_tensor(pts_np, device=dev)
    mask8 = torch.as_tensor(mask_np, device=dev)
    pts2, mask2 = pts8[:2].contiguous(), mask8[:2].contiguous()
    pts1, mask1 = pts8[:1].contiguous(), mask8[:1].contiguous()
    paths = {}

    # R5. PartA2.yaml training at full width, B2 ---------------------------
    t0 = time.perf_counter()
    trainer = build_trainer(cfg, dev, seed=0, total_steps=50)
    batch2 = trainer.make_batch(pts2, mask2, gt_np[:2])
    print('[parta2 R5] PartA2.yaml train B2 (f32, loads %s): voxels %s of cap'
          ' %d, seg fg voxels %s, GT %s, anchors %d, ROI_PER_IMAGE %d; the '
          'last 4 of the 512 RoI slots a sample are GT boxes, moved and '
          'grown' % (
              tuple(trainer.model.module.rpn_net.loads),
              batch2['voxel_mask'].sum(1).tolist(), trainer.max_voxels,
              (batch2['seg_labels'] > 0).sum(1).tolist(),
              (batch2['gt_boxes'][..., 3] > 0).sum(1).tolist(),
              trainer.model.anchors.shape[0],
              int(cfg.MODEL.RCNN.TARGET_CONFIG.ROI_PER_IMAGE)))
    steps = 5
    parta2_gt_proposals(trainer.model, batch2['gt_boxes'])
    _, counts, (a_total, f_total), dw_pairs = parta2_train_steps(
        '[parta2 R5]', trainer, batch2, steps)
    del trainer.model.proposals
    expect = {k: v * steps for k, v in PARTA2_TRAIN_LAUNCHES.items()}
    require(counts == expect, 'launches over %d steps %s, want %s'
            % (steps, counts, expect))
    for cin, cout, _ in DECODER_PAIRS:
        require(dw_pairs.get(('gather_dw_seg', cin, cout), 0) > 0,
                "D' (%d, %d) did not launch" % (cin, cout))
    paths['rotated_overlap'] = {'parta2 train B2, %d steps (R5)' % steps:
                                a_total}
    paths['nms_fused'] = {'parta2 train B2, %d steps (R5)' % steps: f_total}
    r5 = 'parta2 train B2, %d steps (R5)' % steps
    paths['gather_gemm_f32'] = {r5: counts.get('gather_gemm_f32', 0)
                                + counts.get('gather_gemm_f32_dgrad', 0)}
    paths['gather_dw'] = {r5: counts.get('gather_dw', 0)}
    paths['gather_dw_seg'] = {r5: counts.get('gather_dw_seg', 0)}
    print('[parta2 R5] %.1f s' % (time.perf_counter() - t0))

    mark('R5')
    # R6. B1 GPU vs CPU, the new instances, the window loads --------------
    t0 = time.perf_counter()
    k_trainer, b1, src = parta2_four_ways('[parta2 R6]', cfg, dev, pts1,
                                          mask1, gt_np[:1])
    stats = decoder_pairs_vs_plain(dev, b1)
    del k_trainer, b1
    window_pairs = parta2_window_steps(cfg, dev, pts1, mask1, gt_np[:1], src)
    print('[parta2 R6] %.1f s' % (time.perf_counter() - t0))

    mark('R6')
    # R7. ms per step at B2 and B8; PartA2_fc.yaml --------------------------
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True       # the trainer's default
    try:
        parta2_train_times('[parta2 R7] PartA2.yaml (cuDNN TF32 on)', trainer,
                           pts8, mask8, {2: gt_np[:2], 8: gt_np}, profile=True)
        del trainer, batch2
        sync()
        cfg_fc = detect_mod.load_config(detect_mod.PARTA2_FC_CFG)
        fc = build_trainer(cfg_fc, dev, seed=0, total_steps=50)
        batch = fc.make_batch(pts2, mask2, gt_np[:2])
        parta2_gt_proposals(fc.model, batch['gt_boxes'])
        _, counts, (fc_a, fc_f), _ = parta2_train_steps(
            '[parta2 R7] PartA2_fc.yaml train B2 (FCRCNN, 12^3, dropout %.1f)'
            % float(cfg_fc.MODEL.RCNN.DP_RATIO), fc, batch, 3)
        require(counts == {k: v * 3 for k, v in
                           PARTA2_TRAIN_LAUNCHES.items()},
                'PartA2_fc launches %s' % counts)
        paths['rotated_overlap']['parta2_fc train B2, 3 steps (R7)'] = fc_a
        paths['nms_fused']['parta2_fc train B2, 3 steps (R7)'] = fc_f
        del fc, batch
    finally:
        torch.backends.cudnn.allow_tf32 = False
    sync()
    print('[parta2 R7] %.1f s' % (time.perf_counter() - t0))

    entries = []
    for entry_name, st in stats.items():
        name = st['name']
        cin, cout = (int(x) for x in entry_name.split('@')[1].split('x'))
        if name.startswith('gather_gemm'):
            src_file, kname = GEMM_SRC, name.rsplit('_', 1)[0]
        else:
            src_file = ('pcdet_tpu_torch/csrc/gather_dw.cu'
                        if name == 'gather_dw' else DW_SRC)
            kname = name
        by_path = {}
        for loads, counted in window_pairs.items():
            n = counted.get((name, cin, cout), 0)
            if n:
                by_path['parta2 B1 train step under loads %s (R6)'
                        % (loads,)] = n
        n5 = dw_pairs.get((name, cin, cout), 0)
        if n5:
            by_path['parta2 train B2, %d steps (R5)' % steps] = n5
        entry = kernel_entry(entry_name, src_file, REPLACES[kname],
                             n5 or max(by_path.values(), default=0),
                             st['err'], st['ms'], st['plain_ms'], st['work'])
        entry['launches_by_path'] = by_path
        require(entry['launches'] > 0, '%s: no launch on a path' % entry_name)
        entries.append(entry)
    return entries, paths


def parta2_cli(dev, root, out_root, sets, val_infos):
    """R8: the train CLI on PartA2.yaml, 1 epoch of 2 B2 batches (the books
    from the loader's `batch_transform`, the Part-A² targets from the
    loader): finite losses, B, D and D' launch, no tap outside its window;
    then R4: the test CLI on its checkpoint over the KITTI tree's first 4
    val frames: kernel C on every conv, kernel A, the logged AP string
    equal to the evaluator on result.pkl.  Returns the launches of A and C
    (test CLI) and of B, D, D' (train CLI)."""
    import os
    import pickle

    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.datasets.kitti import kitti_eval_cli
    from pcdet_tpu_torch.ops import sparse
    from pcdet_tpu_torch.tools import test as test_cli
    from pcdet_tpu_torch.tools import train as train_cli

    clamped = []
    real_selectors = sparse.xwin_selectors

    def selectors(*args, **kw):
        out = real_selectors(*args, **kw)
        clamped.append(int(out[2]))
        return out
    sparse.xwin_selectors = selectors
    try:
        reset_launches()
        reset_overlap()
        t0 = time.perf_counter()
        tout = train_cli.main(
            ['--cfg_file', str(detect_mod.PARTA2_CFG), '--batch_size', '2',
             '--epochs', '1', '--workers', '4', '--ckpt_save_interval', '1',
             '--log_interval', '1', '--extra_tag', 'chip_smoke', '--device',
             dev.type, '--set'] + sets)
        sync()
        train_counts = nonzero(all_launches())
        train_a, train_f = overlap_launches()
    finally:
        sparse.xwin_selectors = real_selectors
    losses = [float(x) for x in log_records(tout['log_file'],
                                            r'iter \d+ loss (\S+) ')]
    overflow = log_records(tout['log_file'], r'loss \S+ lr \S+ (overflow/.*)')
    print('[parta2 R8] train CLI PartA2.yaml B2, 1 epoch of %d steps in %.2f '
          's: loss %s; %s; launches %s, kernel A %d, kernel F %d; selector '
          'builds %d, taps outside their window %d' % (
              len(losses), time.perf_counter() - t0, losses, overflow,
              train_counts, train_a, train_f, len(clamped), sum(clamped)))
    require(len(losses) == 2 and all(np.isfinite(losses)),
            'Part-A2 train CLI losses %s' % losses)
    for key in ('gather_gemm_f32', 'gather_gemm_f32_dgrad', 'gather_dw',
                'gather_dw_seg'):
        require(train_counts.get(key, 0) > 0, 'Part-A2 train CLI: no launch '
                'of %s' % key)
    require(train_a > 0 and train_f > 0 and clamped and sum(clamped) == 0,
            'Part-A2 train CLI: kernel A %d, kernel F %d, %d selector builds, '
            '%d taps outside their window' % (train_a, train_f, len(clamped),
                                              sum(clamped)))
    ckpt = os.path.join(str(tout['ckpt_dir']), 'checkpoint_epoch_1.pth')
    require(os.path.exists(ckpt), 'Part-A2 train CLI wrote no checkpoint')
    del tout
    sync()
    reset_launches()
    reset_overlap()
    t0 = time.perf_counter()
    out = test_cli.main(
        ['--cfg_file', str(detect_mod.PARTA2_CFG), '--batch_size', '2',
         '--workers', '4', '--extra_tag', 'chip_smoke', '--device', dev.type,
         '--ckpt', ckpt, '--set'] + sets)
    sync()
    counts = nonzero(all_launches())
    a_launches, f_launches = overlap_launches()
    eval_dir, result = out['results'][1]
    with open(os.path.join(str(eval_dir), 'result.pkl'), 'rb') as f:
        det_annos = pickle.load(f)
    again, _ = kitti_eval_cli.evaluation(det_annos, val_infos, KITTI_CLASSES)
    logged = logged_result(out['log_file'])
    print('[parta2 R4] test CLI PartA2.yaml on R8\'s checkpoint, '
          '%d val frames at B2 in %.2f s: launches %s, kernel A %d, kernel F '
          '%d; recall/gt %s, rcnn_0.5 %s, rcnn_0.7 %s; %d detections; '
          'Car_3d_moderate %s; logged AP string == the evaluator on '
          'result.pkl: %s' % (
              len(det_annos), time.perf_counter() - t0, counts, a_launches,
              f_launches,
              result['recall/gt'], result['recall/rcnn_0.5'],
              result['recall/rcnn_0.7'],
              sum(a['num_example'] for a in det_annos),
              result.get('Car_3d_moderate'), logged == again.strip()))
    require(len(det_annos) == len(val_infos) and result['recall/gt'] > 0,
            'Part-A2 test CLI: %d annos, recall/gt %s'
            % (len(det_annos), result['recall/gt']))
    require(counts.get('gather_gemm_bf16', 0) == PARTA2_CONVS * (
        -(-len(val_infos) // 2)) and a_launches > 0 and f_launches > 0,
        'Part-A2 test CLI: launches %s, kernel A %d, kernel F %d'
        % (counts, a_launches, f_launches))
    require(all(np.isfinite(float(v)) for v in result.values()),
            'Part-A2 test CLI: a result is not finite')
    require(finite_numbers(logged) and logged == again.strip(),
            'Part-A2 test CLI: the logged AP string differs from the '
            'evaluator on result.pkl')
    return {'rotated_overlap': {'cli_eval parta2 (R4)': a_launches,
                                'cli_train parta2 (R8)': train_a},
            'nms_fused': {'cli_eval parta2 (R4)': f_launches,
                          'cli_train parta2 (R8)': train_f},
            'gather_gemm_bf16': {'cli_eval parta2 (R4)':
                                 counts['gather_gemm_bf16']},
            'gather_gemm_f32': {'cli_train parta2 (R8)':
                                train_counts['gather_gemm_f32']
                                + train_counts['gather_gemm_f32_dgrad']},
            'gather_dw': {'cli_train parta2 (R8)': train_counts['gather_dw']},
            'gather_dw_seg': {'cli_train parta2 (R8)':
                              train_counts['gather_dw_seg']}}


# ----------------------------------------------------------------------------
# F1-F4: the BEVSEG fork's paths at the full width of the argo PointPillar
# config (tools/cfgs/argo/pointpillar_forward50x50_pseudolidar.yaml)
# ----------------------------------------------------------------------------

ARGO_PL_CFG = 'tools/cfgs/argo/pointpillar_forward50x50_pseudolidar.yaml'
# how the fork switches its paths on
FORK_SETS = ['USE_PSEUDOLIDAR', 'True', 'MODE', '3dobjdet+bev']
FORK_STRIDE = 2            # pixels of the 375 x 1242 depth map lifted


def fork_config(path, sets=FORK_SETS):
    """The config at `path` with the `--set` pairs `sets` applied."""
    from pcdet_tpu_torch.config import (cfg_from_list, cfg_from_yaml_file,
                                        cfg_preprocess)
    cfg = cfg_from_yaml_file(path)
    cfg_from_list(list(sets), cfg)
    return cfg_preprocess(cfg)


def fork_inputs(dev, batch, seed=0):
    """Seeded camera inputs for `batch` frames: depth maps (B, 375, 1242) of
    5-45 m, smooth (a 12 x 40 field, bilinear), and a one-channel semantic
    map (B, 375, 1242) in [0, 1), on `dev` (f32; the CPU's draws, so every
    device gets the same), and BEV masks (B, 200, 200, 2) in {0, 1}."""
    gen = torch.Generator().manual_seed(seed)
    coarse = torch.rand((batch, 1, 12, 40), generator=gen)
    depth = 5 + 40 * torch.nn.functional.interpolate(
        coarse, size=(IMAGE_H, IMAGE_W), mode='bilinear',
        align_corners=False)[:, 0]
    sem = torch.rand((batch, IMAGE_H, IMAGE_W), generator=gen)
    bev = (torch.rand((batch, 200, 200, 2), generator=gen) > 0.5).float()
    return depth.to(dev), sem.to(dev), bev.to(dev)


def fork_points(depth, sem, max_points, stride=FORK_STRIDE):
    """Pseudo-LiDAR scans from depth maps through `CalibrationTorch`
    (KITTI_P2 / KITTI_V2C), padded to `max_points`, and the
    `point_feature_fn` that puts the semantic map's value at each lifted
    pixel into the 4th channel: (points (B, P, 4) with channel 3 zero,
    point_mask (B, P), fn).  Differentiable in depth and sem."""
    from pcdet_tpu_torch.experiments import pseudolidar_points_from_depth
    from pcdet_tpu_torch.utils.calibration import (Calibration,
                                                   CalibrationTorch)
    calib = CalibrationTorch(Calibration({
        'P2': KITTI_P2, 'R0': np.eye(3, dtype=np.float32),
        'Tr_velo2cam': KITTI_V2C}), depth.device, depth.dtype)
    b, h, w = depth.shape
    xyz = torch.stack([pseudolidar_points_from_depth(d, calib, stride=stride)
                       for d in depth])
    n = xyz.shape[1]
    require(n <= max_points, '%d lifted points > MAX_POINTS %d'
            % (n, max_points))
    top, bottom = int(h * 0.35), int(h - h * 0.15)
    vv, uu = torch.meshgrid(
        torch.arange(top, bottom, stride, device=depth.device),
        torch.arange(0, w, stride, device=depth.device), indexing='ij')
    sem_pts = sem[:, vv.reshape(-1), uu.reshape(-1)]          # (B, n)
    pad = max_points - n
    points = torch.nn.functional.pad(
        torch.cat([xyz, torch.zeros_like(xyz[..., :1])], -1), (0, 0, 0, pad))
    mask = torch.zeros((b, max_points), dtype=torch.bool,
                       device=depth.device)
    mask[:, :n] = True
    sem_pad = torch.nn.functional.pad(sem_pts, (0, pad))

    def paint(p):
        return torch.cat([p[..., :3], sem_pad[..., None]], -1)
    return points, mask, paint


def fork_batch(trainer, depth, sem, bev, gt):
    """A fork train batch: the lift, the paint, `make_batch`, the BEV masks
    (in the model's dtype)."""
    dtype = next(trainer.model.module.parameters()).dtype
    points, mask, paint = fork_points(
        depth, sem, int(trainer.cfg.DATA_CONFIG.MAX_POINTS))
    batch = trainer.make_batch(points, mask, gt, point_feature_fn=paint)
    batch['bev'] = bev.to(dtype)
    batch['box_reg_targets'] = batch['box_reg_targets'].to(dtype)
    return batch


def run_fork(dev, smi, cfg_path=ARGO_PL_CFG):
    """Phases F1-F4 (`smi`: the card's name and power limit, for F4's
    lines); returns kernels A's and F's launches on the fork's paths:
    {name: {path: n}}."""
    import os
    import pickle
    import tempfile

    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.datasets.kitti import kitti_eval_cli
    from pcdet_tpu_torch.experiments import (BEVSegEvalAccumulator,
                                             between_dataloading_and_feedforward,
                                             bev_seg_loss)
    from pcdet_tpu_torch.tools import create_data
    from pcdet_tpu_torch.tools import test as test_cli
    from pcdet_tpu_torch.tools import train as train_cli
    from pcdet_tpu_torch.train.trainer import build_trainer, make_train_scans

    here = os.path.dirname(os.path.abspath(__file__))
    cfg_file = os.path.join(here, cfg_path)
    cfg = fork_config(cfg_file)
    paths = {'rotated_overlap': {}, 'nms_fused': {}}

    # F1. full-width training from pseudo-LiDAR, B2, 3 steps ---------------
    steps = 3
    trainer = build_trainer(cfg, dev, seed=0, total_steps=50)
    require(trainer.revoxelizes and trainer.model.with_bev_seg,
            'the fork config did not switch the hook and the head on')
    depth8, sem8, bev8 = fork_inputs(dev, 8)
    _, _, gt8 = make_train_scans(cfg, 8)
    depth = depth8[:2].clone().requires_grad_(True)
    sem = sem8[:2].clone().requires_grad_(True)
    head0 = [p.detach().clone()
             for p in trainer.model.module.bev_seg_head.parameters()]
    tbs = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = fork_batch(trainer, depth, sem, bev8[:2], gt8[:2])
        tbs.append({k: v.item() for k, v in trainer.step(
            batch, inputs=(depth, sem) if i == 0 else ()).items()})
        if i == 0:
            g_depth, g_sem = trainer.state.input_grads
    sync()
    wall = time.perf_counter() - t0
    n_pts = int(batch['point_mask'].sum(1).max())
    losses = [tb['loss'] for tb in tbs]
    moved = max((p.detach() - q).abs().max().item() for p, q in zip(
        trainer.model.module.bev_seg_head.parameters(), head0))
    g_stats = [(torch.isfinite(g).all().item(), g.abs().max().item(),
                int((g != 0).sum())) for g in (g_depth, g_sem)]
    print('[fork F1] %s with %s, B2: %d pseudo-LiDAR points a frame (depth '
          '375 x 1242 at stride %d, padded to %d), %d steps on one batch in '
          '%.2f s: loss %s; bev_loss %s, miou %s; overflow/voxelizer %s' % (
              cfg_path, ' '.join(FORK_SETS), n_pts, FORK_STRIDE,
              batch['points'].shape[1], steps, wall,
              ', '.join('%.5f' % x for x in losses),
              ', '.join('%.5f' % tb['bev_loss'] for tb in tbs),
              ', '.join('%.4f' % tb['miou'] for tb in tbs),
              [tb['overflow/voxelizer'] for tb in tbs]))
    print('[fork F1] last tb %s; bev_seg_head moved by up to %.3g; d loss / '
          'd depth (finite, max |g|, nonzero) %s, d loss / d semantic %s' % (
              {k: round(v, 5) for k, v in tbs[-1].items()}, moved,
              g_stats[0], g_stats[1]))
    require(all(np.isfinite(v) for tb in tbs for v in tb.values()),
            'fork training: a non-finite loss term')
    require(all('bev_loss' in tb and 'miou' in tb for tb in tbs),
            'fork training: no bev_loss / miou in the tb')
    require(losses[-1] < losses[0], 'fork loss did not fall in %d steps: %s'
            % (steps, losses))
    require(moved > 0, 'the BEV head\'s weights did not move')
    require(all(ok and mx > 0 and nz > 0 for ok, mx, nz in g_stats),
            'd loss / d depth or d semantic not finite and nonzero: %s'
            % g_stats)
    require(all('overflow/voxelizer' in tb for tb in tbs),
            'overflow/voxelizer is not in the tb')

    # the fork config's detect at B2 through kernel A (NMS) --------------
    det = detect_mod.build_detector(cfg, dev, state_dict={
        k: v for k, v in trainer.model.module.state_dict().items()})
    with torch.no_grad():
        det.model.module.rpn_head.conv_cls.bias.zero_()
        points, mask, paint = fork_points(depth.detach(), sem.detach(),
                                          int(cfg.DATA_CONFIG.MAX_POINTS))
        points = paint(points)
    det.detect(points, mask)
    sync()
    reset_overlap()
    with torch.inference_mode():
        vox, ret = det.forward(points, mask)
        preds = det.model.predict(ret)
    sync()
    a1, f1 = overlap_launches()
    paths['rotated_overlap']['fork argo detect B2 (F1)'] = a1
    paths['nms_fused']['fork argo detect B2 (F1)'] = f1
    logits = ret['bev_seg_logits']
    print('[fork F1] argo detect B2 (conv_cls bias zeroed): num %s, kernel '
          'A launches %d, kernel F %d (one per NMS call); bev_seg_logits %s '
          '%s finite %s' % (
              preds['num'].tolist(), a1, f1, tuple(logits.shape),
              logits.dtype, bool(torch.isfinite(logits).all())))
    require(f1 > 0, 'the argo detect launched no kernel F')
    require(tuple(logits.shape) == (2, 200, 200, 2)
            and bool(torch.isfinite(logits).all()), 'BEV logits')
    del trainer, det, batch, vox, ret
    sync()

    mark('F1')
    # F2. one B1 step, GPU vs CPU, f32 and f64, with d loss / d inputs ----
    def make_b1(tr, d, dtype):
        dep = depth8[:1].to(d, dtype).requires_grad_(True)
        sm = sem8[:1].to(d, dtype).requires_grad_(True)
        b1 = fork_batch(tr, dep, sm, bev8[:1].to(d), gt8[:1])
        return b1, {'input.depth': dep, 'input.semantic': sm}
    out = step_four_ways('[fork F2]', 'B1 (lift, hook, forward + BEV loss + '
                         'backward)', cfg, dev, 50, make_b1)
    print('[fork F2] GPU and CPU f32 pillar coords equal: %s' % torch.equal(
        out['G32'][2], out['C32'][2]))

    mark('F2')
    # F3. the CLI pair on a fabricated argo-layout KITTI tree -------------
    with tempfile.TemporaryDirectory() as tmp:
        root, out_root = os.path.join(tmp, 'kitti'), os.path.join(tmp, 'out')
        t0 = time.perf_counter()
        write_kitti_tree(root, 4, 2)
        rng = np.random.RandomState(0)
        for cls in ('DRIVABLE', 'VEHICLE'):
            d = os.path.join(root, 'training', 'bev_%s' % cls)
            os.makedirs(d)
            for i in range(6):
                m = (rng.rand(400, 400) > 0.6).astype(np.uint8) * 255
                with open(os.path.join(d, '%06d.png' % i), 'wb') as f:
                    f.write(grey_png_bytes(m))
        create_data.main(['kitti', '--cfg_file', cfg_file, '--data_path',
                          root, '--workers', '4'])
        sets = cli_sets(root, out_root) + FORK_SETS
        argv = ['--cfg_file', cfg_file, '--batch_size', '2', '--epochs', '1',
                '--workers', '4', '--ckpt_save_interval', '1',
                '--log_interval', '1', '--extra_tag', 'chip_smoke',
                '--device', dev.type, '--set'] + sets
        tout = train_cli.main(argv)
        sync()
        t_train = time.perf_counter() - t0
        losses = [float(x) for x in log_records(
            tout['log_file'], r'iter \d+ loss (\S+) ')]
        bev_losses = [float(x) for x in log_records(
            tout['log_file'], r'bev_loss (\S+) ')]
        tb_dir = os.path.join(str(tout['output_dir']), 'tensorboard')
        events = os.listdir(tb_dir) if os.path.isdir(tb_dir) else []
        print('[fork F3] tree of 4 + 2 frames with 400 x 400 BEV maps, '
              'create_data, train CLI %s B2 1 epoch (2 steps, 4 thread '
              'workers) in %.2f s: loss %s, bev_loss %s; tensorboard %s' % (
                  ' '.join(FORK_SETS), t_train, losses, bev_losses,
                  events or 'not written (no tensorboardX)'))
        require(tout['trainer'].revoxelizes, 'the train CLI did not switch '
                'the hook on')
        require(len(losses) == len(bev_losses) == 2
                and all(np.isfinite(losses + bev_losses)),
                'train CLI: losses %s, bev_loss %s' % (losses, bev_losses))
        reset_overlap()
        t0 = time.perf_counter()
        res = test_cli.main([
            '--cfg_file', cfg_file, '--batch_size', '2', '--workers', '4',
            '--extra_tag', 'chip_smoke', '--device', dev.type, '--ckpt',
            os.path.join(str(tout['ckpt_dir']), 'checkpoint_epoch_1.pth'),
            '--set'] + sets + ['MODEL.TEST.SCORE_THRESH', '0.0'])
        sync()
        a_launches, f_launches = overlap_launches()
        paths['rotated_overlap']['fork CLI eval (F3)'] = a_launches
        paths['nms_fused']['fork CLI eval (F3)'] = f_launches
        eval_dir, result = res['results'][1]
        with open(os.path.join(str(eval_dir), 'result.pkl'), 'rb') as f:
            det_annos = pickle.load(f)
        with open(os.path.join(root, 'kitti_infos_val.pkl'), 'rb') as f:
            val_infos = pickle.load(f)
        again, _ = kitti_eval_cli.evaluation(det_annos, val_infos,
                                             KITTI_CLASSES)
        logged = logged_result(res['log_file'])
        # the BEV head over the eval batches against the loader's masks
        det = res['detector']
        acc = BEVSegEvalAccumulator(2)
        from pcdet_tpu_torch.datasets import build_dataloader
        fcfg = test_cli.parse_config(['--cfg_file', cfg_file, '--set']
                                     + sets)[1]
        ds, loader = build_dataloader(fcfg, 2, training=False, num_workers=0)
        with torch.inference_mode():
            for item in loader:
                acc.add_batch(det.model.forward(det.upload(item))
                              ['bev_seg_logits'], item['bev'])
        miou = acc.results()
        print('[fork F3] test CLI on its checkpoint, %d val frames in %.2f '
              's: kernel A launches %d (recall), kernel F %d (NMS); recall/gt '
              '%s; logged AP string == the evaluator on result.pkl: %s; '
              'BEVSegEvalAccumulator %s' % (
                  len(det_annos), time.perf_counter() - t0, a_launches,
                  f_launches,
                  result['recall/gt'], logged == again.strip(),
                  {k: round(float(v), 4) for k, v in miou.items()}))
        require(a_launches > 0 and f_launches > 0, 'the fork test CLI '
                'launched kernel A %d, kernel F %d times'
                % (a_launches, f_launches))
        require(logged == again.strip(), 'fork test CLI: the logged AP '
                'string differs from the evaluator run again on result.pkl')
        require(finite_numbers(logged), 'fork test CLI: non-finite AP')
        require(np.isfinite(miou['test_miou']), 'test_miou not finite')
        del det, res, tout
    sync()

    mark('F3')
    # F4. ms per step with and without the hook and the head --------------
    settings = (('hook + BEV head', FORK_SETS),
                ('hook only', FORK_SETS[:2]),
                ('BEV head only (voxels made before the step)',
                 FORK_SETS[2:]),
                ('neither (voxels made before the step)', []))
    for name, sets in settings:
        c = fork_config(cfg_file, sets)
        trainer = build_trainer(c, dev, seed=0, total_steps=50)
        for b in ((2, 8) if name.startswith(('hook + ', 'neither')) else
                  (2,)):
            with torch.no_grad():
                points, mask, paint = fork_points(
                    depth8[:b], sem8[:b], int(c.DATA_CONFIG.MAX_POINTS))
                points = paint(points)
            batch = trainer.make_batch(points, mask, gt8[:b])
            if trainer.model.with_bev_seg:
                batch['bev'] = bev8[:b]
            trainer.step(batch)                                  # warm-up
            sync()
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                trainer.step(batch)
                sync()
                ms.append(1e3 * (time.perf_counter() - t0))
            step_ms = sorted(ms)[1]
            extra = ''
            if trainer.revoxelizes:
                revox = cuda_ms(lambda: between_dataloading_and_feedforward(
                    batch, c, train=True), 5)
                extra += '; re-voxelization %.2f ms' % revox
            if trainer.model.with_bev_seg:
                head = trainer.model.module.bev_seg_head
                with torch.no_grad():
                    feats = trainer.model.forward(
                        between_dataloading_and_feedforward(batch, c))[
                            'spatial_features_last']
                feats = torch.randn_like(feats).requires_grad_(True)

                def head_fwd_bwd():
                    loss, _ = bev_seg_loss(head(feats), bev8[:b])
                    torch.autograd.grad(loss, [feats] + list(
                        head.parameters()))
                extra += ('; BEV head forward + backward %.2f ms'
                          % cuda_ms(head_fwd_bwd, 5))
            print('[fork F4 B%d] %s: %.2f ms per step (median of 3, '
                  'prebuilt; %s), %.2f samples/s%s (CUDA events); %s' % (
                      b, name, step_ms, ', '.join('%.2f' % x for x in ms),
                      1e3 * b / step_ms, extra, smi))
            if b == 2 and name.startswith(('hook + ', 'neither')):
                busy, rows = profile_train(trainer, batch)
                if not rows or busy > step_ms:
                    print('[fork F4 B2] %s: device busy / idle not measured '
                          '(no device time recorded, or more than the '
                          'unprofiled step)' % name)
                else:
                    print('[fork F4 B2] %s: device busy %.2f ms per step '
                          '(torch.profiler), idle %.1f%% of the unprofiled '
                          'step; top kernels: %s' % (
                              name, busy, 100 * (1 - busy / step_ms),
                              '; '.join('%.3f ms %s' % (t, k[:60])
                                        for t, k in rows[:6])))
            del batch
        del trainer
        sync()
    return paths


# ----------------------------------------------------------------------------
# M1-M3: data-parallel training over torch.distributed
# ----------------------------------------------------------------------------

DDP_WORLD = 2
DDP_MODES = ('per_rank', 'sync')
DDP_STEPS = 3
SPARSE_PLAIN_NAMES = ('gather_gemm', 'gather_gemm_xwin', 'gather_gemm_seg',
                      'gather_dw', 'gather_dw_xwin', 'gather_dw_seg')


class plain_sparse:
    """Context: the sparse convs and the RoI sampler's IoU through their
    kernels' plain versions (the kernels take f32 only; P64 runs the plain
    versions in f64)."""

    def __init__(self, on=True):
        self.on = on

    def __enter__(self):
        from pcdet_tpu_torch.models import roi_heads
        from pcdet_tpu_torch.ops import gather_dw as gd
        from pcdet_tpu_torch.ops import gather_gemm as gg
        from pcdet_tpu_torch.ops import gather_xwin as gx
        from pcdet_tpu_torch.ops import rotated_iou
        from pcdet_tpu_torch.ops import rotated_overlap as ro
        from pcdet_tpu_torch.ops import sparse
        self.kernels = {n: getattr(sparse, n) for n in SPARSE_PLAIN_NAMES}
        self.iou = roi_heads.rois_iou3d
        plains = {'gather_gemm': gg.gather_gemm_plain,
                  'gather_gemm_xwin': gx.gather_gemm_xwin_plain,
                  'gather_gemm_seg': gx.gather_gemm_seg_plain,
                  'gather_dw': gd.gather_dw_plain,
                  'gather_dw_xwin': gd.gather_dw_xwin_plain,
                  'gather_dw_seg': gd.gather_dw_seg_plain}
        if self.on:
            for n, fn in plains.items():
                setattr(sparse, n, lambda *a, _fn=fn, dgrad=False: _fn(*a))
            roi_heads.rois_iou3d = lambda r, g: (
                rotated_iou.boxes_iou3d_batched(
                    r, g, ro.pair_overlap_batched_plain))
        return self

    def __exit__(self, *exc):
        from pcdet_tpu_torch.models import roi_heads
        from pcdet_tpu_torch.ops import sparse
        for n, fn in self.kernels.items():
            setattr(sparse, n, fn)
        roi_heads.rois_iou3d = self.iou


def ddp_config(model):
    from pcdet_tpu_torch import detect as detect_mod
    return detect_mod.load_config(detect_mod.SECOND_CFG if model == 'second'
                                  else detect_mod.PARTA2_CFG)


def ddp_counts(model):
    """Wrap a Part-A² model's loss to keep the counts its global
    normalizers sum: fg RoIs (`fg_sum`), valid class labels (`cls_valid`),
    positive voxels (`pos_norm`), this rank's."""
    counts = {}
    real = model.loss

    def loss(ret, batch):
        rc = ret['rcnn']
        counts.update(fg_sum=int((rc['reg_valid_mask'] > 0).sum()),
                      cls_valid=int((rc['rcnn_cls_labels'] >= 0).sum()),
                      pos_norm=int((batch['seg_labels'] > 0).sum()))
        return real(ret, batch)
    model.loss = loss
    return counts


def ddp_trainer(job, cfg, dev, group, bn_groups, dtype, rank, world, scans):
    """A trainer of the job's model on this rank's samples, its batch (the
    floats in `dtype`), and Part-A²'s RoIs injected from `job['inject']` or
    recorded (GT slots) into the returned rec."""
    from pcdet_tpu_torch.train.trainer import build_trainer
    tr = build_trainer(cfg, dev, seed=0, total_steps=10, bn_groups=bn_groups,
                       process_group=group, sync_bn=job['sync_bn'])
    model = tr.model
    parta2_to(tr, dtype)
    b = job['batch'] // world
    sl = slice(rank * b, rank * b + b)
    pts, mask, gt = scans
    batch = tr.make_batch(torch.as_tensor(pts[sl], device=dev),
                          torch.as_tensor(mask[sl], device=dev), gt[sl])
    batch = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
             else v for k, v in batch.items()}
    rec = None
    src = job.get('inject')
    if src is not None:
        r = int(src['picks'].shape[1])
        parta2_inject(model, {
            'roi': {k: v[sl] for k, v in src['roi'].items()},
            'picks': src['picks'][sl],
            'masks': [m[rank * b * r:(rank * b + b) * r]
                      for m in src['masks']]}, dev, dtype)
    elif job.get('record'):
        parta2_gt_proposals(model, batch['gt_boxes'])
        rec = parta2_record(model)
    return tr, batch, rec


def unequal_across_ranks(trainer, group):
    """The names of the state tensors (parameters, buffers, optimizer
    moments) in which this rank differs from rank 0, bit for bit, and
    whether the step counts differ."""
    import torch.distributed as dist
    from pcdet_tpu_torch.parallel import ddp
    sd = trainer.state.state_dict()
    tensors = {'model.' + k: v for k, v in sd['model_state'].items()}
    for slot, d in sd['optimizer_state']['state'].items():
        tensors.update({'opt.%s.%s' % (slot, k): v for k, v in d.items()})
    bad = []
    for name, t in tensors.items():
        ref = t.detach().clone().contiguous()
        dist.broadcast(ref, 0, group=group)
        if not torch.equal(ref, t):
            bad.append(name)
    counts = ddp.all_gather_object(
        (sd['it'], sd['optimizer_state']['count']), group)
    return bad, len(set(counts)) > 1


def ddp_run(job, dev, group=None, rank=0, bn_groups=1):
    """One M1 / M2 job on one rank (or, without a group, the one-process
    reference on the whole batch): per dtype ('float32' through the
    kernels, 'float64' through their plain versions) the step's loss
    (summed over the ranks) and this rank's share, the tb summed, the
    gradients (summed, rank 0's, on the CPU), the BN running statistics
    after rank 0's broadcast, this rank's kernel launches and Part-A²'s
    counts; in f32 under a group, the gradient all-reduce's ms; in f32,
    `job['steps']` steps (ms, losses, launches, and under a group the
    tensors that differ from rank 0's)."""
    from pcdet_tpu_torch.parallel import ddp
    from pcdet_tpu_torch.train.trainer import make_train_scans
    cfg = job['cfg']
    world = ddp.world_size(group)
    scans = make_train_scans(cfg, job['batch'], ring_keep=0.35)
    out = {}
    for name in job['dtypes']:
        f64 = name == 'float64'
        dtype = torch.float64 if f64 else torch.float32
        res = {}
        with plain_sparse(f64):
            tr, batch, rec = ddp_trainer(job, cfg, dev, group, bn_groups,
                                         dtype, rank, world, scans)
            counts = (ddp_counts(tr.model) if job['model'] == 'parta2'
                      else {})
            sync()
            reset_launches()
            reset_overlap()
            loss, tb, grads = tr.state.loss_and_grads(batch)
            ddp.broadcast_buffers(tr.model.module, group)
            sync()
            res['launches'] = dict(nonzero(all_launches()), **dict(zip(
                'AF', overlap_launches())))
            res['loss'] = float(ddp.all_sum(loss.detach(), group))
            res['share'] = float(loss)
            res['tb'] = {k: float(v) for k, v in
                         ddp.reduce_tb(tb, group).items()}
            res['counts'] = dict(counts)
            names = [n for n, _ in tr.model.module.named_parameters()]
            if rank == 0:
                res['grads'] = {n: g.detach().double().cpu()
                                for n, g in zip(names, grads)}
                res['stats'] = {
                    k: v.detach().double().cpu() for k, v in
                    tr.model.module.state_dict().items()
                    if k.endswith(('running_mean', 'running_var'))}
            if rec is not None:
                res['inject'] = {
                    'roi': {k: v.detach().cpu() for k, v in
                            rec['roi'].items()},
                    'picks': tr.model.last_sampler['picks'].cpu(),
                    'masks': [d.last_mask.cpu()
                              for d in tr.model.dropouts()]}
            if group is not None and not f64:
                ms = []
                for _ in range(3):
                    ddp.barrier(group)
                    sync()
                    t0 = time.perf_counter()
                    ddp.all_reduce_grads([g.clone() for g in grads], group)
                    sync()
                    ms.append(1e3 * (time.perf_counter() - t0))
                res['allreduce_ms'] = sorted(ms)[1]
                res['grad_mb'] = sum(g.numel() * g.element_size()
                                     for g in grads) / 2 ** 20
                if torch.distributed.get_backend(group) == 'nccl':
                    res['collective_ms'] = collective_ms(
                        sum(g.numel() for g in grads), dev, group)
            del grads
            if not f64 and job.get('steps'):
                # the steps go on from the step above (its BN statistics,
                # equal on every rank after the broadcast)
                reset_launches()
                reset_overlap()
                ms, losses = [], []
                for _ in range(job['steps']):
                    ddp.barrier(group)
                    sync()
                    t0 = time.perf_counter()
                    tb = tr.step(batch)
                    sync()
                    ms.append(1e3 * (time.perf_counter() - t0))
                    losses.append(float(ddp.reduce_tb(tb, group)['loss']))
                res['step_launches'] = dict(nonzero(all_launches()),
                                            **dict(zip('AF',
                                                       overlap_launches())))
                res['step_ms'], res['step_losses'] = ms, losses
                if group is not None:
                    res['unequal'] = unequal_across_ranks(tr, group)
            if dev.type == 'cuda':
                # what this process put on the host's other cards (0 bytes:
                # the rank's work stays on its card)
                res['elsewhere'] = {
                    i: torch.cuda.max_memory_allocated(i)
                    for i in range(torch.cuda.device_count())
                    if i != dev.index}
            del tr, batch
        out[name] = res
    return out


def collective_ms(numel, dev, group, iters=10):
    """Mean device ms of one `all_reduce` of a flat f32 buffer of `numel`
    elements over `group` (CUDA events around `iters` calls after 3, the
    ranks lined up by a barrier): the collective alone, without the
    gradient bucketing's copies and Python."""
    import torch.distributed as dist
    from pcdet_tpu_torch.parallel import ddp
    flat = torch.zeros(numel, dtype=torch.float32, device=dev)
    for _ in range(3):
        dist.all_reduce(flat, group=group)
    ddp.barrier(group)
    sync()
    return cuda_ms(lambda: dist.all_reduce(flat, group=group), iters,
                   warmup=0)


def ddp_rank(rank, group, path, jobs):
    """M1 / M2 (M4) on one rank: a process spawned by `ddp.launch_local`
    on the one card over gloo (NCCL refuses two ranks on one device), or
    on its own card over NCCL (a job's 'device' None: the card `ddp.init`
    made current)."""
    from pcdet_tpu_torch.parallel import ddp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // ddp.world_size(group)))
    ddp.save_rank_result(path, rank, [
        ddp_run(job, torch.device(job['device']) if job['device'] else
                torch.device('cuda', torch.cuda.current_device()),
                group, rank)
        for job in jobs])


def ddp_module_errs(got, want):
    """Per gradient (or statistic) name, |got - want| / max |want|, and the
    largest per module group."""
    groups = grad_groups(want)
    each, per = {}, {}
    for n, w in want.items():
        scale = w.abs().max().item()
        each[n] = (got[n] - w).abs().max().item() / (scale if scale else 1.0)
        per[groups[n]] = max(per.get(groups[n], 0.0), each[n])
    return each, per


def ddp_l2(got, want):
    """||got - want|| / ||want|| over every tensor of the dicts."""
    num = sum(float(((got[n] - w) ** 2).sum()) for n, w in want.items())
    den = sum(float((w ** 2).sum()) for w in want.values())
    return (num / den) ** 0.5 if den else num ** 0.5


def ddp_report(tag, job, ranks, ref, mode):
    """Print and check one M1 / M2 job: the ranks against the one-process
    reference (P64, the one-process step in f64 through the plain versions,
    referees the f32 steps), the launches per rank, the steps."""
    what = ('one process, bn_groups %d' % len(ranks) if mode == 'per_rank'
            else 'one process, one BN group')
    p64 = ref['float64']
    for name in job['dtypes']:
        f64 = name == 'float64'
        kind = 'P64 (plain versions, f64)' if f64 else 'K32 (the kernels)'
        got, want = ranks[0][name], ref[name]
        rel = abs(got['loss'] - want['loss']) / abs(want['loss'])
        each, per = ddp_module_errs(got['grads'], want['grads'])
        stats = max(ddp_module_errs(got['stats'], want['stats'])[0].values())
        print('[ddp %s %s] %s: loss, the ranks\' shares %s summed %.10g vs '
              '%s %.10g (rel %.3g); gradients summed over the ranks vs one '
              'process, largest error / max |grad| %.3g, per module: %s; BN '
              'running statistics (rank 0\'s, broadcast) %.3g of max' % (
                  tag, mode, kind, ', '.join('%.8g' % r[name]['share']
                                             for r in ranks), got['loss'],
                  what, want['loss'], rel, max(each.values()),
                  ', '.join('%s %.2e' % x for x in per.items()), stats))
        require(all(r[name]['loss'] == got['loss'] for r in ranks),
                '%s %s: the ranks\' summed losses differ' % (tag, name))
        if f64:
            require(rel <= 1e-9 and max(each.values()) <= 1e-9
                    and stats <= 1e-9, '%s %s P64: loss %g, gradients %g, BN '
                    'statistics %g of max from one process' % (
                        tag, mode, rel, max(each.values()), stats))
        else:
            # each f32 step against the f64 one: f32 runs of one batch split
            # two ways sit up to ~1e-1 of max apart in the BN-cancelling
            # tensors (T4, R6, M1-M2), so the ranks' f32 step is held to be
            # as accurate as the one process's: its relative L2 error over
            # all gradients within twice the one process's (or 1e-3), and
            # each gradient's own relative L2 error under 0.3 (a rank's
            # share left unsummed is off by about 0.5 or more)
            _, rank_per = ddp_module_errs(got['grads'], p64['grads'])
            _, one_per = ddp_module_errs(want['grads'], p64['grads'])
            l2_rank = ddp_l2(got['grads'], p64['grads'])
            l2_one = ddp_l2(want['grads'], p64['grads'])
            each_l2 = {n: ddp_l2({n: got['grads'][n]}, {n: w})
                       for n, w in p64['grads'].items()}
            worst = max(each_l2, key=each_l2.get)
            print('[ddp %s %s] K32 against P64 (the one-process step in '
                  'f64): relative L2 over all gradients, the ranks\' %.3g, '
                  'one process\'s %.3g; one gradient\'s largest, the '
                  'ranks\' %s %.3g (one process %.3g); largest error / max '
                  '|grad| per module, the ranks\' / one process\'s: %s' % (
                      tag, mode, l2_rank, l2_one, worst, each_l2[worst],
                      ddp_l2({worst: want['grads'][worst]},
                             {worst: p64['grads'][worst]}), ', '.join(
                          '%s %.2e / %.2e' % (k, v, one_per[k])
                          for k, v in rank_per.items())))
            require(rel <= 1e-4 and stats <= 1e-3
                    and l2_rank <= max(1e-3, 2 * l2_one)
                    and each_l2[worst] <= 0.3,
                    '%s %s K32: loss %g relative, BN statistics %g of max, '
                    'relative L2 %g (one process %g), %s %g' % (
                        tag, mode, rel, stats, l2_rank, l2_one, worst,
                        each_l2[worst]))
        for r, rank in enumerate(ranks):
            res = rank[name]
            print('[ddp %s %s] %s rank %d: launches %s%s' % (
                tag, mode, name, r, res['launches'],
                '; fg_sum %d, cls_valid %d, pos_norm %d' % (
                    res['counts']['fg_sum'], res['counts']['cls_valid'],
                    res['counts']['pos_norm']) if res['counts'] else ''))
        if f64:
            continue
        for r, rank in enumerate(ranks):
            res = rank[name]
            keys = ('gather_gemm_f32', 'gather_gemm_f32_dgrad', 'gather_dw',
                    'gather_dw_seg') + (('A', 'F') if job['model'] == 'parta2'
                                        else ())
            for launches in (res['launches'], res['step_launches']):
                require(all(launches.get(k, 0) > 0 for k in keys),
                        '%s %s rank %d: launches %s lack one of %s' % (
                            tag, mode, r, launches, keys))
            require(not any(res.get('elsewhere', {}).values()),
                    '%s %s rank %d: bytes allocated on the other cards %s' % (
                        tag, mode, r, res.get('elsewhere')))
            bad, steps_differ = res['unequal']
            print('[ddp %s %s] rank %d: %d steps, loss %s, ms a step %s '
                  '(%s); gradient all-reduce %.2f ms for %.1f MB (median of '
                  '3); launches over the steps %s; state tensors differing '
                  'from rank 0\'s, bit for bit: %d; bytes on the other cards '
                  '%s' % (
                      tag, mode, r, len(res['step_ms']),
                      ', '.join('%.6f' % x for x in res['step_losses']),
                      ', '.join('%.2f' % x for x in res['step_ms']),
                      job.get('how', 'two gloo ranks on one card'),
                      res['allreduce_ms'], res['grad_mb'],
                      res['step_launches'], len(bad),
                      res.get('elsewhere', 'not read')))
            require(not bad and not steps_differ, '%s %s rank %d: after %d '
                    'steps the state differs from rank 0\'s in %s' % (
                        tag, mode, r, DDP_STEPS, bad[:5]))
        require(all(r[name]['step_losses'] == ranks[0][name]['step_losses']
                    for r in ranks), '%s %s: the ranks\' step losses differ'
                % (tag, mode))
        if job['model'] == 'parta2':
            c = [r[name]['counts'] for r in ranks]
            total = {k: sum(x[k] for x in c) for k in c[0]}
            print('[ddp %s %s] global fg_sum %d, cls_valid %d, pos_norm %d; '
                  'tb rpn_pos_num %g, rcnn_loss_reg %.6g, rcnn_loss_corner '
                  '%.6g' % (tag, mode, total['fg_sum'], total['cls_valid'],
                            total['pos_norm'], got['tb']['rpn_pos_num'],
                            got['tb']['rcnn_loss_reg'],
                            got['tb']['rcnn_loss_corner']))
            require(all(x['fg_sum'] > 0 for x in c)
                    and got['tb']['rcnn_loss_reg'] > 0
                    and total['pos_norm'] == got['tb']['rpn_pos_num'],
                    '%s %s: counts %s, tb %s' % (tag, mode, c, got['tb']))


def run_ddp(dev):
    """Phases M1 (SECOND) and M2 (Part-A²) over two gloo ranks on the one
    card; returns the ranks' launches by kernel entry name and path."""
    import os
    import tempfile
    from pcdet_tpu_torch.parallel import ddp
    jobs, refs = [], []
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    t0 = time.perf_counter()
    for model, phase in (('second', 'M1'), ('parta2', 'M2')):
        for mode in DDP_MODES:
            groups = DDP_WORLD if mode == 'per_rank' else 1
            job = {'model': model, 'cfg': ddp_config(model),
                   'device': str(dev), 'batch': DDP_WORLD,
                   'steps': DDP_STEPS, 'sync_bn': mode == 'sync',
                   'tag': phase, 'mode': mode,
                   'dtypes': (('float32', 'float64') if model == 'second'
                              else ('float32',))}
            if model == 'parta2':
                # the run that records the RoIs is the f32 reference: the
                # others take its proposals and picks, so compute its step
                ref = ddp_run(dict(job, record=True, steps=0), dev,
                              bn_groups=groups)
                job['inject'] = ref['float32'].pop('inject')
                ref.update(ddp_run(dict(job, steps=0, dtypes=('float64',)),
                                   dev, bn_groups=groups))
            else:
                ref = ddp_run(dict(job, steps=0, dtypes=(
                    'float32', 'float64')), dev, bn_groups=groups)
            refs.append(ref)
            jobs.append(job)
    sync()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    t_ref = time.perf_counter() - t0
    # the ranks share the card with this process: hand back its cached
    # blocks first
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'result')
        ddp.launch_local(ddp_rank, DDP_WORLD, (path, jobs), backend='gloo',
                         device=dev, timeout=900)
        ranks = ddp.load_rank_results(path, DDP_WORLD)
    t_ranks = time.perf_counter() - t0
    print('[ddp M1-M2] one-process references (Part-A²\'s RoIs recorded) '
          '%.1f s; %d gloo ranks on the one card, spawned, all jobs: %.1f s'
          % (t_ref, DDP_WORLD, t_ranks))
    paths = {}
    for i, (job, ref) in enumerate(zip(jobs, refs)):
        tag = '%s %s' % (job['tag'], job['model'])
        ddp_report(tag, job, [r[i] for r in ranks], ref, job['mode'])
        for r, rank in enumerate(ranks):
            res = rank[i]['float32']
            counts = {k: res['launches'].get(k, 0)
                      + res['step_launches'].get(k, 0)
                      for k in set(res['launches']) | set(
                          res['step_launches'])}
            where = 'ddp %s %s rank %d (B1 step + %d steps)' % (
                job['tag'], job['mode'], r, DDP_STEPS)
            for entry, keys in (
                    ('gather_gemm_f32', ('gather_gemm_f32',
                                         'gather_gemm_f32_dgrad')),
                    ('gather_dw', ('gather_dw',)),
                    ('gather_dw_seg', ('gather_dw_seg',)),
                    ('rotated_overlap', ('A',)), ('nms_fused', ('F',))):
                n = sum(counts.get(k, 0) for k in keys)
                if n:
                    paths.setdefault(entry, {})[where] = n
    return paths


M3_DRIVER = """\"\"\"The train CLI with deterministic cuDNN and torch algorithms, timing
the gradient all-reduce (chip_smoke.py M3, M4); rank 0 prints the times.\"\"\"
import os
import sys
import time

T_START = time.time()
import torch  # noqa: E402

torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True, warn_only=True)

from pcdet_tpu_torch.parallel import ddp  # noqa: E402
from pcdet_tpu_torch.tools import train  # noqa: E402

real = ddp.all_reduce_grads
times, nbytes = [], []


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(grads, group, *args, **kw):
    sync()
    t0 = time.perf_counter()
    out = real(grads, group, *args, **kw)
    sync()
    times.append(1e3 * (time.perf_counter() - t0))
    nbytes.append(sum(g.numel() * g.element_size() for g in grads))
    return out


ddp.all_reduce_grads = timed
T_MAIN = time.time()
train.main(sys.argv[1:])
if os.environ.get('RANK', '0') == '0':
    print('M3_ALLREDUCE_MS ' + ' '.join('%.4f' % t for t in times))
    print('M3_GRAD_MB %.2f' % (max(nbytes, default=0) / 2 ** 20))
    print('M3_TIMES %.3f %.3f %.3f' % (T_START, T_MAIN, time.time()))
"""


def train_cli_start(tag, launch, argv, env, cwd):
    """Start the train CLI (`launch` + `argv`, in a subprocess under `env`
    in `cwd`); returns the run for `train_cli_finish`."""
    proc = subprocess.Popen(launch + argv, cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return tag, proc, time.perf_counter(), time.time()


def train_cli_finish(run, out_root, phase, timeout=600):
    """Wait for a run of `train_cli_start` (the driver script `M3_DRIVER`
    under `python` or torchrun) and read it: wall time and its split, rank
    0's gradient all-reduce ms and MB, the ops without a deterministic
    implementation, its output directory and rank 0's log, the epochs
    (index, s, iterations) and the logged losses."""
    tag, proc, t0, t_wall = run
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t0
    t_end = time.time()
    require(proc.returncode == 0, '%s train %s failed:\n%s\n%s' % (
        phase, tag, stdout[-3000:], stderr[-3000:]))
    ar = [float(x) for line in stdout.splitlines()
          if line.startswith('M3_ALLREDUCE_MS')
          for x in line.split()[1:]]
    mb = [float(line.split()[1]) for line in stdout.splitlines()
          if line.startswith('M3_GRAD_MB')]
    nondet = sorted({m for m in re.findall(
        r'UserWarning: (.*?) does not have a deterministic', stderr)})
    out, = glob.glob(os.path.join(out_root, 'output', '*', tag))
    logs = sorted(x for x in os.listdir(out) if x.startswith('log_train_'))
    with open(os.path.join(out, logs[-1])) as f:
        text = f.read()
    marks = [float(x) for line in stdout.splitlines()
             if line.startswith('M3_TIMES') for x in line.split()[1:]]
    split = ('start %.1f s, imports %.1f s, main %.1f s, exit %.1f s' % (
        marks[0] - t_wall, marks[1] - marks[0], marks[2] - marks[1],
        t_end - marks[2]) if len(marks) == 3 else 'not measured')
    return {'wall': wall, 'split': split, 'allreduce_ms': ar,
            'grad_mb': mb[0] if mb else float('nan'),
            'out': out, 'log': text, 'nondeterministic': nondet,
            'epochs': [(int(n), float(t), int(i)) for n, t, i in
                       re.findall(r'epoch (\d+) done in ([0-9.]+)s '
                                  r'\((\d+) iters\)', text)],
            'losses': [float(x) for x in re.findall(
                r'iter \d+ loss (\S+) ', text)]}


def train_cli_env(here):
    """The environment of a train CLI subprocess: the checkout on the
    path, the host pipeline's threads set (torchrun sets OMP_NUM_THREADS
    to 1 where it is unset), deterministic cuBLAS, no torchrun variables
    of this process."""
    env = dict(os.environ, PYTHONPATH=here, OMP_NUM_THREADS='4',
               CUBLAS_WORKSPACE_CONFIG=':4096:8')
    for key in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT'):
        env.pop(key, None)
    return env


def run_ddp_cli(dev, workdir):
    """M3: the train CLI under torchrun (`--multi_host`, NCCL, one rank) on
    L1's tree (`workdir`/kitti), 2 epochs, bitwise against the same 2
    epochs without a group, launched beside it; its checkpoint restored
    bitwise; the test CLI on it through kernel A."""
    import pickle
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.datasets.kitti import kitti_eval_cli
    from pcdet_tpu_torch.tools import test as test_cli
    from pcdet_tpu_torch.tools import train as train_cli
    from pcdet_tpu_torch.train.checkpoint import restore_train_state
    from pcdet_tpu_torch.train.trainer import build_trainer
    from pcdet_tpu_torch.weights import load_checkpoint
    here = os.path.dirname(os.path.abspath(__file__))
    pp_cfg = str(detect_mod.DEFAULT_CFG)
    root, out_root = (os.path.join(workdir, 'kitti'),
                      os.path.join(workdir, 'out'))
    with open(os.path.join(root, 'kitti_infos_val.pkl'), 'rb') as f:
        val_infos = pickle.load(f)
    with open(os.path.join(root, 'kitti_infos_train.pkl'), 'rb') as f:
        per_epoch = len(pickle.load(f)) // 2
    backend = 'NCCL' if dev.type == 'cuda' else 'gloo'
    sets = cli_sets(root, out_root)
    os.makedirs(out_root, exist_ok=True)
    driver = os.path.join(out_root, 'm3_train.py')
    with open(driver, 'w') as f:
        f.write(M3_DRIVER)
    # one environment for both launches
    env = train_cli_env(here)
    torchrun = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
                '--nproc_per_node', '1', driver, '--multi_host']

    def start(tag, epochs, launch):
        argv = ['--cfg_file', pp_cfg, '--batch_size', '2', '--epochs',
                str(epochs), '--workers', '4', '--ckpt_save_interval', '1',
                '--log_interval', '1', '--extra_tag', tag, '--device',
                dev.type, '--set'] + sets
        return train_cli_start(tag, launch, argv, env, here)

    def differing(a, b):
        """The names of the tensors of two states (on any devices) that
        differ, bit for bit."""
        out = [k for k, v in a['model_state'].items()
               if not torch.equal(v.cpu(), b['model_state'][k].cpu())]
        return out + ['opt.%s.%s' % (slot, k)
                      for slot, d in a['optimizer_state']['state'].items()
                      for k, v in d.items() if not torch.equal(
                          v.cpu(), b['optimizer_state']['state'][slot][k]
                          .cpu())]

    gc.collect()
    torch.cuda.empty_cache()
    # the two launches share the card and run side by side
    runs = [start('m3_ddp', 2, torchrun),
            start('m3_plain', 2, [sys.executable, driver])]
    first, plain = [train_cli_finish(r, out_root, 'M3') for r in runs]
    last = os.path.join(first['out'], 'ckpt', 'checkpoint_epoch_2.pth')
    a = load_checkpoint(last)
    b = load_checkpoint(os.path.join(plain['out'], 'ckpt',
                                     'checkpoint_epoch_2.pth'))
    differ = differing(a, b)
    # rank 0's checkpoint resumes: restored into a trainer of other weights
    # on this device, every tensor of its state is the file's
    tcfg = train_cli.parse_config(['--cfg_file', pp_cfg, '--set'] + sets)[1]
    resumed = build_trainer(tcfg, dev, seed=1, iters_each_epoch=per_epoch,
                            epochs=2)
    _, epoch = restore_train_state(last, resumed.state)
    c = resumed.state.state_dict()
    differ_resumed = differing(c, a)
    del resumed
    reset_overlap()
    t0 = time.perf_counter()
    tout = test_cli.main(
        ['--cfg_file', pp_cfg, '--batch_size', '2', '--workers', '4',
         '--extra_tag', 'm3', '--device', dev.type, '--ckpt', last,
         '--set'] + sets + ['MODEL.TEST.SCORE_THRESH', '0.0'])
    sync()
    t_test = time.perf_counter() - t0
    a_launches, f_launches = overlap_launches()
    ar = first['allreduce_ms']
    for tag, run in (('torchrun, epochs 1-2', first),
                     ('no group, epochs 1-2, beside it', plain)):
        print('[ddp M3] train CLI pointpillar.yaml B2 on L1\'s tree, %s: '
              '%.1f s wall (%s); epochs (index, s, iterations) %s; loss %s; '
              'ops without a deterministic implementation %s' % (
                  tag, run['wall'], run['split'], run['epochs'], ', '.join(
                      '%.4f' % x for x in run['losses']),
                  run['nondeterministic'] or 'none'))
    print('[ddp M3] checkpoint_epoch_2 under torchrun --multi_host (%s, 1 '
          'rank, deterministic cuDNN) it %d, without a group it %d: tensors '
          'differing bit for bit %d of %d; restored (`restore_train_state`) '
          'into a trainer of other weights: epoch %d, it %d, tensors '
          'differing from the file %d; gradient all-reduce (%s, W=1) of '
          '%.2f MB %.4f ms a step (median of %d, %.4f-%.4f)' % (
              backend, a['it'], b['it'], len(differ),
              len(a['model_state']) + sum(
                  len(d) for d in a['optimizer_state']['state'].values()),
              epoch, c['it'], len(differ_resumed), backend,
              first['grad_mb'], float(np.median(ar)) if ar else float('nan'), len(ar),
              min(ar, default=float('nan')), max(ar, default=float('nan'))))
    require('rank 0 of 1' in first['log'], 'M3: the run did not join a '
            'group')
    require(len(plain['losses']) == 2 * per_epoch
            and plain['losses'] == first['losses']
            and all(np.isfinite(plain['losses'])),
            'M3 losses: torchrun %s, no group %s' % (first['losses'],
                                                     plain['losses']))
    require(a['it'] == b['it'] == c['it'] == 2 * per_epoch and epoch == 2
            and not differ and not differ_resumed,
            'M3: under torchrun the state differs from the run without a '
            'group in %s, restored in %s' % (differ[:5], differ_resumed[:5]))
    require(len(ar) == 2 * per_epoch, 'M3: %d all-reduces timed' % len(ar))
    eval_dir, result = tout['results'][2]
    with open(os.path.join(str(eval_dir), 'result.pkl'), 'rb') as f:
        det_annos = pickle.load(f)
    again, _ = kitti_eval_cli.evaluation(det_annos, val_infos, KITTI_CLASSES)
    logged = logged_result(tout['log_file'])
    print('[ddp M3] test CLI on the torchrun checkpoint, %d val frames in '
          '%.2f s: kernel A launches %d, kernel F %d; recall/gt %s; '
          'logged AP string == the evaluator on result.pkl: %s' % (
              len(det_annos), t_test, a_launches, f_launches,
              result['recall/gt'], logged == again.strip()))
    require(a_launches > 0 and f_launches > 0 and logged == again.strip()
            and finite_numbers(logged), 'M3 test CLI: A %d, F %d, AP string '
            'equal %s' % (a_launches, f_launches, logged == again.strip()))
    return {'rotated_overlap': {'ddp M3 test CLI': a_launches},
            'nms_fused': {'ddp M3 test CLI': f_launches}}


# M4: every card of the host ------------------------------------------------

# the NVLink rate each way between two cards of an H100 SXM host (NVIDIA's
# data sheet: 900 GB/s to the other cards, all to all, 450 GB/s each way)
NVLINK_BYTES_PER_S = 450e9
# the window-structured kw=3 book of M4 (a): batch, table rows, output rows,
# x-groups (27 taps), channels in and out (conv2_1's instance)
CARD_BOOK = (2, 20000, 16000, 9, 32, 32)


def card_kernel_inputs(seed=0, book=CARD_BOOK):
    """CPU inputs of one launch of every kernel, from `seed`: kernel A's NMS
    shape (G = 2, 64 x 4096 random boxes' corners) for A, A' (its first
    group) and A''; a window-structured kw=3 book (`book`: bases ascending
    along the rows as a sorted book's are, a quarter of the x-taps missing,
    the last rows' windows at the table's end), its rules for B, C, D and
    the selector kernel, its (base, sel) for E, E', D'', D'; a table (row
    V_in zero), weights, an output gradient, n_live all and three
    quarters."""
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import rotated_iou
    rng = np.random.RandomState(seed)
    b, v_in, v_out, groups, cin, cout = book
    corners = rotated_iou.boxes5_to_corners(torch.as_tensor(
        rand_boxes5(rng, (2, 4096)))).contiguous()
    table = rng.randn(b, v_in + 1, cin).astype(np.float32)
    table[:, v_in] = 0
    base = np.sort(rng.randint(0, v_in - 2, (b, v_out, groups)), axis=1)
    off = rng.randint(0, 3, (b, v_out, groups, 3))
    off[rng.rand(b, v_out, groups, 3) < 0.25] = 3             # misses
    base[:, -3:], off[:, -3:] = v_in - 1, [0, 3, 3]
    sel = off[..., 0] | (off[..., 1] << 2) | (off[..., 2] << 4)
    base = torch.as_tensor(base.astype(np.int32))
    sel = torch.as_tensor(sel.astype(np.int32))
    return {'ca': corners[:, :64].contiguous(), 'cb': corners,
            'table': torch.as_tensor(table), 'base': base, 'sel': sel,
            'rules': gx.rules_from_xwin(base, sel, v_in).contiguous(),
            'w': torch.as_tensor(
                rng.randn(3 * groups, cin, cout).astype(np.float32) * 0.2),
            'g': torch.as_tensor(rng.randn(b, v_out, cout).astype(np.float32)),
            'n_live': torch.as_tensor(
                np.array([v_out, 3 * v_out // 4][:b], np.int32))}


# each entry: the kernels' outputs by name, the launch counter it moves, and
# its plain version's tolerance (a fraction of max |plain|; 0: bitwise)
CARD_KERNELS = {
    'A': ('rotated_overlap', 0.0), "A'": ('rotated_overlap', 0.0),
    "A''": ('rotated_overlap_sorted', 0.0),
    'B': ('gather_gemm_f32', 1e-5), 'C': ('gather_gemm_bf16', 1e-5),
    'D': ('gather_dw', 1e-4), "D'": ('gather_dw_seg', 1e-4),
    "D''": ('gather_dw_xwin', 1e-4),
    'E f32': ('gather_gemm_xwin_f32', 1e-5),
    'E bf16': ('gather_gemm_xwin_bf16', 1e-5),
    "E' f32": ('gather_gemm_seg_f32', 1e-5),
    "E' bf16": ('gather_gemm_seg_bf16', 1e-5),
    'selectors': ('xwin_selectors', 0.0)}


def card_launches():
    """Every kernel's launch counter, by `CARD_KERNELS`' names."""
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    return dict(all_launches(), rotated_overlap=ro.LAUNCHES,
                rotated_overlap_sorted=ro.LAUNCHES_SORTED)


def card_kernel_outputs(dev, inputs, plain=False):
    """{name: output (a tuple for the selectors), on the CPU} of one launch
    of each kernel with its operands on `dev`, or of its plain version."""
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    t = {k: v.to(dev) for k, v in inputs.items()}
    ca, cb, base, sel, nl = t['ca'], t['cb'], t['base'], t['sel'], t['n_live']
    tables = {'f32': (t['table'], t['w']),
              'bf16': (t['table'].bfloat16(), t['w'].bfloat16())}
    v_in = int(t['table'].shape[1]) - 1
    if plain:
        a = ro.pair_overlap_batched_plain
        fns = {'A': lambda: a(ca, cb), "A'": lambda: a(ca[:1], cb[:1])[0],
               "A''": lambda: ro.pair_overlap_sorted_plain(ca, cb),
               'selectors': lambda: gx.xwin_selectors_plain(t['rules'], v_in)}
        gemm, dw = gg.gather_gemm_plain, gd.gather_dw_plain
        xwin, seg = gx.gather_gemm_xwin_plain, gx.gather_gemm_seg_plain
        dw_xwin, dw_seg = gd.gather_dw_xwin_plain, gd.gather_dw_seg_plain
    else:
        fns = {'A': lambda: ro.pair_overlap_batched(ca, cb),
               "A'": lambda: ro.pair_overlap(ca[0], cb[0]),
               "A''": lambda: ro.pair_overlap_sorted_batched(ca, cb),
               'selectors': lambda: gx.xwin_selectors(t['rules'], v_in)}
        gemm, dw = gg.gather_gemm, gd.gather_dw
        xwin, seg = gx.gather_gemm_xwin, gx.gather_gemm_seg
        dw_xwin, dw_seg = gd.gather_dw_xwin, gd.gather_dw_seg
    fns.update({
        'B': lambda: gemm(t['table'], t['rules'], t['w'], nl),
        'C': lambda: gemm(tables['bf16'][0], t['rules'], tables['bf16'][1],
                          nl),
        'D': lambda: dw(t['table'], t['rules'], t['g'], nl),
        "D'": lambda: dw_seg(t['table'], base, sel, t['g'], nl),
        "D''": lambda: dw_xwin(t['table'], base, sel, t['g'], nl)})
    for kind, (table, w) in tables.items():
        fns['E ' + kind] = (lambda tb=table, ww=w: xwin(tb, base, sel, ww, nl))
        fns["E' " + kind] = (lambda tb=table, ww=w: seg(tb, base, sel, ww, nl))
    out = {}
    for name in CARD_KERNELS:
        got = fns[name]()
        out[name] = (tuple(x.cpu() for x in got) if isinstance(got, tuple)
                     else got.cpu())
    return out


def outputs_equal(a, b):
    """Two `card_kernel_outputs` values bitwise equal (NaN equal to NaN)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(outputs_equal, a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


def kernels_on_second_card(inputs, first=0, second=1):
    """Every kernel with its operands on card `second`, launched from a new
    thread whose current device is card `first`: (its outputs, the launches
    it counted, the thread's current device before and after, the bytes it
    allocated on card `first` at its peak, the outputs' devices)."""
    def run():
        before = torch.cuda.current_device()
        torch.cuda.synchronize(first)
        torch.cuda.reset_peak_memory_stats(first)
        held = torch.cuda.memory_allocated(first)
        counts = card_launches()
        out = card_kernel_outputs(torch.device('cuda', second), inputs)
        torch.cuda.synchronize(second)
        launches = {k: v - counts[k] for k, v in card_launches().items()
                    if v != counts[k]}
        return (out, launches, (before, torch.cuda.current_device()),
                torch.cuda.max_memory_allocated(first) - held)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(run).result()


def fresh_build_rank(rank, group, path, build_dir):
    """M4 (a) on one rank spawned on card `rank`: kernel A's library and the
    host book builder built at once by every rank into one fresh
    `build_dir`, then kernel A on its card against its plain version."""
    from pathlib import Path
    from pcdet_tpu_torch.ops import cuda_build, host_books
    from pcdet_tpu_torch.ops import rotated_iou
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    from pcdet_tpu_torch.parallel import ddp
    cuda_build.BUILD_DIR = Path(build_dir)
    dev = torch.device('cuda', torch.cuda.current_device())
    corners = rotated_iou.boxes5_to_corners(torch.as_tensor(
        rand_boxes5(np.random.RandomState(rank), (1, 1024)),
        device=dev)).contiguous()
    ddp.barrier(group)              # every rank starts its builds at once
    t0 = time.perf_counter()
    native = host_books.native_lib()
    got = ro.pair_overlap_batched(corners[:, :64].contiguous(), corners)
    want = ro.pair_overlap_batched_plain(corners[:, :64], corners)
    sync()
    ddp.save_rank_result(path, rank, {
        'device': str(got.device), 'equal': bool(torch.equal(got, want)),
        'native': native is not None, 's': time.perf_counter() - t0,
        'cached': cuda_build.BUILD_LOG['rotated_overlap']['cached']})


def run_cards_kernels(world):
    """M4 (a): every kernel on cuda:1 from a thread whose current device is
    cuda:0, bitwise equal to the same launch on cuda:0 and within its
    plain version's tolerance on cuda:1; kernel A'''s blocks an SM and
    device time on each card; `world` ranks building at once into one
    fresh build directory."""
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    from pcdet_tpu_torch.parallel import ddp
    t0 = time.perf_counter()
    inputs = card_kernel_inputs()
    first = card_kernel_outputs(torch.device('cuda', 0), inputs)
    sync()
    got, launches, current, peak = kernels_on_second_card(inputs)
    plain = card_kernel_outputs(torch.device('cuda', 1), inputs, plain=True)
    rows = []
    for name, (counter, tol) in CARD_KERNELS.items():
        equal = outputs_equal(got[name], first[name])
        want = plain[name]
        if isinstance(want, tuple):
            err, ok = 0.0, outputs_equal(got[name], want)
        else:
            scale = float(want.abs().max())
            err = float((got[name] - want).abs().max())
            ok = (outputs_equal(got[name], want) if tol == 0
                  else err <= tol * max(scale, 1e-30))
        rows.append('%s %s (%s launches)' % (name, 'bitwise' if equal else
                                             'DIFFERS', launches.get(counter)))
        require(equal, 'M4 %s: cuda:1 differs from cuda:0' % name)
        require(ok, 'M4 %s: cuda:1 against its plain version, %g' % (
            name, err))
        require(launches.get(counter, 0) > 0, 'M4 %s: no launch counted on '
                'cuda:1 (%s)' % (name, launches))
    print('[ddp M4 a] every kernel on cuda:1 from a thread on cuda:0 '
          '(current device %d before, %d after; %d bytes allocated on '
          'cuda:0 at the peak), against the same launch on cuda:0: %s; each '
          'within its plain version\'s tolerance on cuda:1' % (
              current[0], current[1], peak, ', '.join(rows)))
    require(current == (0, 0) and peak == 0, 'M4: the launches on cuda:1 '
            'moved the current device %s or allocated %d bytes on cuda:0'
            % (current, peak))
    blocks, times = [], []
    fn_inputs = {i: (inputs['ca'].to(i), inputs['cb'].to(i))
                 for i in range(torch.cuda.device_count())}
    for i in range(torch.cuda.device_count()):
        with torch.cuda.device(i):
            blocks.append(ro.sorted_blocks_per_sm())
            ca, cb = fn_inputs[i]
            times.append(queued_ms(
                lambda: ro.pair_overlap_sorted_batched(ca, cb), 50)[0])
    print("[ddp M4 a] kernel A'' at the NMS shape on each card: blocks of "
          "128 an SM %s, device time (queued) %s ms" % (
              blocks, ', '.join('%.4f' % x for x in times)))
    require(len(set(blocks)) == 1, "M4: kernel A''s blocks an SM differ by "
            "card: %s" % blocks)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        build_dir = os.path.join(tmp, 'build')
        path = os.path.join(tmp, 'result')
        ddp.launch_local(fresh_build_rank, world, (path, build_dir),
                         backend='nccl', timeout=300,
                         device=[torch.device('cuda', r)
                                 for r in range(world)])
        ranks = ddp.load_rank_results(path, world)
        left = sorted(os.listdir(build_dir))
    print('[ddp M4 a] %d ranks building kernel A and the host book builder '
          'at once into a fresh build directory (%.1f s with the spawn): '
          'built afresh / reused by rank %s, s %s, kernel A == plain on '
          'each rank\'s card %s; files left %s' % (
              world, time.perf_counter() - t1,
              ['reused' if r['cached'] else 'built' for r in ranks],
              ', '.join('%.1f' % r['s'] for r in ranks),
              [r['equal'] for r in ranks], left))
    require(all(r['equal'] and r['native'] for r in ranks)
            and [r['device'] for r in ranks] == ['cuda:%d' % i
                                                 for i in range(world)]
            and len(left) == 2 and not any('.tmp' in x for x in left),
            'M4: the fresh builds under %d ranks: %s, files %s' % (
                world, ranks, left))
    print('[ddp M4 a] %.1f s' % (time.perf_counter() - t0))


def run_cards_ddp(devices):
    """M4 (b): M1 / M2 over one NCCL rank a card of `devices`, each rank a
    B1 share of the global batch against one process on the first card
    with bn_groups W (per-rank BN) or one BN group (synced BN); each
    model's one-process B1 step on the first card timed beside them.
    Returns (the launches by kernel entry and path, the jobs' results for
    (d))."""
    from pcdet_tpu_torch.parallel import ddp
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world, dev = len(devices), devices[0]
    backend = ddp.default_backend(dev)
    how = '%d %s ranks, one card each' % (world, backend)
    jobs, refs, single = [], [], {}
    t0 = time.perf_counter()
    for model, phase in (('second', 'M4 b'), ('parta2', 'M4 b')):
        for mode in DDP_MODES:
            groups = world if mode == 'per_rank' else 1
            # 'device' None: each rank on the card ddp.init made current
            job = {'model': model, 'cfg': ddp_config(model),
                   'device': None if dev.type == 'cuda' else str(dev),
                   'batch': world, 'steps': DDP_STEPS,
                   'sync_bn': mode == 'sync', 'tag': phase, 'mode': mode,
                   'how': how, 'dtypes': (('float32', 'float64')
                                          if model == 'second'
                                          else ('float32',))}
            if model == 'parta2':
                ref = ddp_run(dict(job, record=True, steps=0), dev,
                              bn_groups=groups)
                job['inject'] = ref['float32'].pop('inject')
                ref.update(ddp_run(dict(job, steps=0, dtypes=('float64',)),
                                   dev, bn_groups=groups))
            else:
                ref = ddp_run(dict(job, steps=0, dtypes=(
                    'float32', 'float64')), dev, bn_groups=groups)
            if mode == 'per_rank':
                # one card, one process, the ranks' B1: the steps timed
                single[model] = ddp_run(dict(job, batch=1, dtypes=(
                    'float32',)), dev)['float32']['step_ms']
            refs.append(ref)
            jobs.append(job)
    sync()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    t_ref = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'result')
        ddp.launch_local(ddp_rank, world, (path, jobs), backend=backend,
                         device=list(devices), timeout=900)
        ranks = ddp.load_rank_results(path, world)
    print('[ddp M4 b] one-process references on %s %.1f s; %s, spawned, '
          'all jobs: %.1f s' % (dev, t_ref, how, time.perf_counter() - t0))
    paths, results = {}, []
    for i, (job, ref) in enumerate(zip(jobs, refs)):
        tag = '%s %s' % (job['tag'], job['model'])
        ddp_report(tag, job, [r[i] for r in ranks], ref, job['mode'])
        results.append((job, [r[i]['float32'] for r in ranks],
                        single[job['model']]))
        for r, rank in enumerate(ranks):
            res = rank[i]['float32']
            counts = {k: res['launches'].get(k, 0)
                      + res['step_launches'].get(k, 0)
                      for k in set(res['launches']) | set(
                          res['step_launches'])}
            where = 'ddp M4 %s %s rank %d on %s (B1 step + %d steps)' % (
                job['model'], job['mode'], r, devices[r], DDP_STEPS)
            for entry, keys in (
                    ('gather_gemm_f32', ('gather_gemm_f32',
                                         'gather_gemm_f32_dgrad')),
                    ('gather_dw', ('gather_dw',)),
                    ('gather_dw_seg', ('gather_dw_seg',)),
                    ('rotated_overlap', ('A',)), ('nms_fused', ('F',))):
                n = sum(counts.get(k, 0) for k in keys)
                if n:
                    paths.setdefault(entry, {})[where] = n
    return paths, results


def run_cards_cli(world, workdir, device_type='cuda'):
    """M4 (c): the train CLI under torchrun at --nproc_per_node `world` on
    pointpillar.yaml, B = 2 `world`, 2 epochs on L1's tree, then the test
    CLI on rank 0's checkpoint through kernel A, its logged AP string equal
    to the evaluator's; the same CLI at one rank, B2, for the samples/s of
    one card at the same per-rank batch.  Returns (kernel A's launches by
    path, the two runs)."""
    import pickle
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.datasets.kitti import kitti_eval_cli
    from pcdet_tpu_torch.tools import test as test_cli
    here = os.path.dirname(os.path.abspath(__file__))
    pp_cfg = str(detect_mod.DEFAULT_CFG)
    root, out_root = (os.path.join(workdir, 'kitti'),
                      os.path.join(workdir, 'out'))
    with open(os.path.join(root, 'kitti_infos_val.pkl'), 'rb') as f:
        val_infos = pickle.load(f)
    sets = cli_sets(root, out_root)
    os.makedirs(out_root, exist_ok=True)
    driver = os.path.join(out_root, 'm4_train.py')
    with open(driver, 'w') as f:
        f.write(M3_DRIVER)
    env = train_cli_env(here)
    runs = {}
    for w in (world, 1):
        tag = 'm4_w%d' % w
        argv = ['--cfg_file', pp_cfg, '--batch_size', str(2 * w),
                '--epochs', '2', '--workers', '4', '--ckpt_save_interval',
                '1', '--log_interval', '1', '--extra_tag', tag, '--device',
                device_type, '--set'] + sets
        launch = [sys.executable, '-m', 'torch.distributed.run',
                  '--standalone', '--nproc_per_node', str(w), driver,
                  '--multi_host']
        runs[w] = train_cli_finish(
            train_cli_start(tag, launch, argv, env, here), out_root, 'M4 c')
        run = runs[w]
        print('[ddp M4 c] train CLI pointpillar.yaml under torchrun '
              '--nproc_per_node %d (%s), B%d (%d a rank), on L1\'s tree: '
              '%.1f s wall (%s); epochs (index, s, iterations) %s; loss %s; '
              'gradient all-reduce (rank 0) of %.2f MB, ms a step %s' % (
                  w, 'NCCL' if device_type == 'cuda' else 'gloo', 2 * w, 2,
                  run['wall'], run['split'], run['epochs'],
                  ', '.join('%.4f' % x for x in run['losses']),
                  run['grad_mb'], ', '.join('%.3f' % x
                                            for x in run['allreduce_ms'])))
        require('rank 0 of %d' % w in run['log'] and len(run['epochs']) == 2
                and run['losses'] and all(np.isfinite(run['losses'])),
                'M4 train CLI at %d ranks: %s' % (w, run['log'][-2000:]))
    last = os.path.join(runs[world]['out'], 'ckpt', 'checkpoint_epoch_2.pth')
    reset_overlap()
    t0 = time.perf_counter()
    tout = test_cli.main(
        ['--cfg_file', pp_cfg, '--batch_size', '2', '--workers', '4',
         '--extra_tag', 'm4', '--device', device_type, '--ckpt', last,
         '--set'] + sets
        + ['MODEL.TEST.SCORE_THRESH', '0.0'])
    sync()
    a_launches, f_launches = overlap_launches()
    eval_dir, result = tout['results'][2]
    with open(os.path.join(str(eval_dir), 'result.pkl'), 'rb') as f:
        det_annos = pickle.load(f)
    again, _ = kitti_eval_cli.evaluation(det_annos, val_infos, KITTI_CLASSES)
    logged = logged_result(tout['log_file'])
    print('[ddp M4 c] test CLI on rank 0\'s checkpoint of %d ranks, %d val '
          'frames on %s in %.2f s: kernel A launches %d, kernel F %d; '
          'recall/gt %s; logged AP string == the evaluator on result.pkl: '
          '%s' % (
              world, len(det_annos), device_type, time.perf_counter() - t0,
              a_launches, f_launches,
              result['recall/gt'], logged == again.strip()))
    require(a_launches > 0 and f_launches > 0 and logged == again.strip()
            and finite_numbers(logged), 'M4 test CLI: A %d, F %d, AP string '
            'equal %s' % (a_launches, f_launches, logged == again.strip()))
    where = 'ddp M4 test CLI (%d-rank checkpoint)' % world
    return {'rotated_overlap': {where: a_launches},
            'nms_fused': {where: f_launches}}, runs


def samples_per_s(run, batch):
    """The train CLI's samples a second over its last epoch (the first
    holds the loader's start and the first steps' warm-up)."""
    _, s, iters = run['epochs'][-1]
    return iters * batch / s


def run_multi_card(workdir):
    """M4 on every card of the host (two or more): (a) every kernel on
    cuda:1 from a thread on cuda:0, and fresh builds under W ranks; (b)
    SECOND and Part-A² steps over W NCCL ranks; (c) the train CLI under
    torchrun at W ranks and the test CLI on its checkpoint; (d) their
    times, with the cards' names, power limits and links.  Returns the
    launches by kernel entry and path."""
    world = torch.cuda.device_count()
    if world < 2:
        print('[ddp M4] needs two cards, %d visible: M4 did not run' % world)
        return {}
    t0 = time.perf_counter()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    topo = subprocess.run(['nvidia-smi', 'topo', '-m'], capture_output=True,
                          text=True)
    links = sorted({x for line in topo.stdout.splitlines()
                    if line.startswith('GPU')
                    for x in line.split()[1:world + 1] if x != 'X'})
    nvlink = subprocess.run(['nvidia-smi', 'nvlink', '--status', '-i', '0'],
                            capture_output=True, text=True)
    speeds = re.findall(r'Link \d+: ([0-9.]+ GB/s)', nvlink.stdout)
    peer = [torch.cuda.can_device_access_peer(0, i) for i in range(1, world)]
    print('[ddp M4] %d cards: %s; links between the cards: nvidia-smi topo '
          '-m %s; card 0\'s NVLink links (nvidia-smi nvlink --status) %s; '
          'peer access from cuda:0 to the others %s' % (
              world, '; '.join(smi),
              links or 'not read (%s)' % (topo.stdout + topo.stderr).strip(),
              '%d x %s' % (len(speeds), sorted(set(speeds))) if speeds else
              'not read (%s)' % (nvlink.stdout + nvlink.stderr).strip()[:200],
              peer))
    run_cards_kernels(world)
    mark('M4 a')
    paths, steps = run_cards_ddp([torch.device('cuda', r)
                                  for r in range(world)])
    mark('M4 b')
    cli_paths, runs = run_cards_cli(world, workdir)
    mark('M4 c')
    for name, by_path in cli_paths.items():
        paths.setdefault(name, {}).update(by_path)
    # (d) the times against their bounds
    factor = 2 * (world - 1) / world
    for job, ranks, one in steps:
        ar = [r['allreduce_ms'] for r in ranks]
        bare = [r['collective_ms'] for r in ranks]
        mb = ranks[0]['grad_mb']
        bound = 1e3 * factor * mb * 2 ** 20 / NVLINK_BYTES_PER_S
        print('[ddp M4 d] %s %s: NCCL all_reduce of one flat %.1f MB buffer '
              '%s ms by rank (CUDA events, mean of 10): %.1f GB/s of bus '
              'bandwidth, 2(W-1)/W x bytes / ms, against %.0f' % (
                  job['model'], job['mode'], mb,
                  ', '.join('%.3f' % x for x in bare),
                  factor * mb * 2 ** 20 / (1e6 * max(bare)),
                  NVLINK_BYTES_PER_S / 1e9))
        step = [float(np.median(r['step_ms'])) for r in ranks]
        one_ms = float(np.median(one))
        print('[ddp M4 d] %s %s: NCCL gradient all-reduce of %.1f MB %s ms '
              'by rank (median of 3 each), bound 2(W-1)/W x bytes over %.0f '
              'GB/s NVLink %.4f ms; a rank\'s B1 step %s ms (median of %d), '
              'one process on one card at B1 %.2f ms; samples/s across %d '
              'cards %.2f against one card %.2f (%.2fx)' % (
                  job['model'], job['mode'], mb,
                  ', '.join('%.3f' % x for x in ar),
                  NVLINK_BYTES_PER_S / 1e9, bound,
                  ', '.join('%.2f' % x for x in step), DDP_STEPS, one_ms,
                  world, 1e3 * world / max(step), 1e3 / one_ms,
                  one_ms * world / max(step)))
    w_run, one_run = runs[world], runs[1]
    many, single = (samples_per_s(w_run, 2 * world),
                    samples_per_s(one_run, 2))
    print('[ddp M4 d] train CLI pointpillar.yaml through the loader (4 '
          'workers a rank), the last epoch: %.2f samples/s across %d cards '
          '(B%d) against %.2f on one card (B2), %.2fx; gradient all-reduce '
          '(rank 0, median) %.3f ms at %d ranks, %.3f at 1, bound %.4f ms' % (
              many, world, 2 * world, single, many / single,
              float(np.median(w_run['allreduce_ms'])), world,
              float(np.median(one_run['allreduce_ms'])),
              1e3 * factor * w_run['grad_mb'] * 2 ** 20
              / NVLINK_BYTES_PER_S))
    print('[ddp M4] %.1f s' % (time.perf_counter() - t0))
    return paths


# K1-K3: the rulebooks built on the card (PCDET_HOST_BOOKS=0) -------------

class device_books_on:
    """Context: PCDET_HOST_BOOKS=0, the sparse models' books built on the
    card (`host_books.use_host_books`); the variable restored on exit."""

    def __enter__(self):
        self.old = os.environ.get('PCDET_HOST_BOOKS')
        os.environ['PCDET_HOST_BOOKS'] = '0'
        return self

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ['PCDET_HOST_BOOKS']
        else:
            os.environ['PCDET_HOST_BOOKS'] = self.old


def books_equal(tag, got, want):
    """Require two decoded book dicts equal element for element (dtype,
    shape, every value); returns the number of tensors compared."""
    require(sorted(got) == sorted(want), '%s: keys %s vs %s'
            % (tag, sorted(got), sorted(want)))
    n = 0
    for key, book in want.items():
        other = got[key]
        for a, b in (zip(book, other) if isinstance(book, tuple)
                     else [(book, other)]):
            require(a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a, b), '%s: book %s differs' % (tag, key))
            n += 1
    return n


def sync_free_books(model, coords, train):
    """`model.device_books` under torch.cuda's sync debug mode 'error': a
    host sync inside the builders raises."""
    torch.cuda.set_sync_debug_mode('error')
    try:
        return model.device_books(coords, train)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def book_stage_ms(model, coords, train, iters=5):
    """(the host stage: coords to the host, the native build, the upload and
    decode, ms by the host clock to synced; the device build's ms on the
    card, queued behind a spin kernel; the host ms to enqueue it; and its
    ms by the host clock to synced)."""
    def host():
        c = coords.cpu().numpy()
        return model.upload_books(model.build_books(c, train), c.shape[1],
                                  train)

    def device():
        return model.device_books(coords, train)

    walls = []
    for fn in (host, device):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        walls.append(1e3 * (time.perf_counter() - t0) / iters)
    dev_ms, enqueue_ms = queued_ms(device, iters)
    return walls[0], dev_ms, enqueue_ms / iters, walls[1]


def books_both_ways(tag, det, coords, train, iters=5):
    """K1 / K2's book check and times at one batch and caps; returns the
    device books."""
    model = det.model
    want = model.upload_books(model.build_books(coords.cpu().numpy(), train),
                              coords.shape[1], train)
    got = sync_free_books(model, coords, train)
    n = books_equal(tag, got, want)
    host_ms, dev_ms, enqueue_ms, wall_ms = book_stage_ms(model, coords, train,
                                                         iters)
    print('%s %s caps: device books == host books (%d tensors, built with '
          'no host sync); live per level %s, drops %s; host stage (copy, '
          'native build, upload) %.2f ms; device build %.2f ms by CUDA '
          'events behind a spin kernel (launch-bound where the %.2f ms a '
          'build takes to enqueue is more), %.2f ms by the host clock to '
          'synced'
          % (tag, 'train' if train else 'eval', n,
             {k: v[2].sum(1).tolist() for k, v in got.items()
              if isinstance(v, tuple)},
             {k: v[3].tolist() for k, v in got.items()
              if isinstance(v, tuple)}, host_ms, dev_ms, enqueue_ms, wall_ms))
    return got


def detect_both_ways(tag, det, pts, mask, runs=3, n=5):
    """Detect on host books and on device books: the predictions equal
    (every tensor), the launches equal; frames/s both ways (median of
    `runs` runs of `n` batches).  Returns the device run's launches (the
    sparse kernels' and A's)."""
    out = {}
    for way in ('host', 'device'):
        with (device_books_on() if way == 'device'
              else contextlib.nullcontext()):
            det.detect(pts, mask)
            sync()
            reset_launches()
            reset_overlap()
            preds = det.detect(pts, mask)
            sync()
            counts = (nonzero(all_launches()), *overlap_launches())
            ms = []
            for _ in range(runs):
                t0 = time.perf_counter()
                for _ in range(n):
                    det.detect(pts, mask)
                sync()
                ms.append(1e3 * (time.perf_counter() - t0) / n)
            out[way] = (preds, counts, sorted(ms)[len(ms) // 2])
    (hp, hc, hms), (dp, dc, dms) = out['host'], out['device']
    for k, v in hp.items():
        require(torch.equal(dp[k], v), '%s: detect %s differs between host '
                'and device books' % (tag, k))
    require(hc == dc, '%s: launches %s with host books, %s with device '
            'books' % (tag, hc, dc))
    b = pts.shape[0]
    print('%s detect B%d: predictions equal on host and device books (num '
          '%s); launches %s, kernel A %d, kernel F %d; %.2f frames/s on host '
          'books (%.2f ms a batch), %.2f on device books (%.2f ms)' % (
              tag, b, hp['num'].tolist(), dc[0], dc[1], dc[2], 1e3 * b / hms,
              hms,
              1e3 * b / dms, dms))
    return dc


def flat_outputs(ret, prefix=''):
    """A model's output dict as (name, tensor) pairs, nested dicts in."""
    out = []
    for k, v in sorted(ret.items()):
        if isinstance(v, dict):
            out += flat_outputs(v, prefix + k + '.')
        elif torch.is_tensor(v):
            out.append((prefix + k, v))
    return out


def geometric_decoder_equal(det, pts, mask):
    """Part-A²'s forward with every inverse conv's book withheld (its rules
    from the geometry, `sparse.inverse_rules_geometric`) against key
    reuse: every output bitwise equal.  Returns the outputs compared."""
    from pcdet_tpu_torch.ops import sparse
    inverse = sparse.inverse_conv3d

    def withheld(level, target, weights, book, *args, rules_t=None,
                 xwin=None, bwd_xwin=None, **kw):
        return inverse(level, target, weights, None, *args, **kw)

    with torch.inference_mode():
        vox = det.voxelize(pts, mask)
        books = det.books(vox)
        ref = flat_outputs(det.model.forward(dict(vox, books=books)))
        sparse.inverse_conv3d = withheld
        try:
            geo = flat_outputs(det.model.forward(dict(vox, books=books)))
        finally:
            sparse.inverse_conv3d = inverse
    sync()
    require([k for k, _ in geo] == [k for k, _ in ref], 'output keys')
    for (k, a), (_, b) in zip(geo, ref):
        require(torch.equal(a, b), 'K2: the geometric inverse rules change '
                '%s' % k)
    return len(ref)


def step_both_ways(cfg, dev, pts, mask, gt):
    """One Part-A² train step's loss and gradients on host and on device
    books from the same seed, TF32 off and deterministic algorithms
    (warnings recorded): {way: (loss, tb, grads, books, launches, A)},
    the parameter names and the ops warned of as nondeterministic."""
    import warnings
    from pcdet_tpu_torch.train import train_state
    from pcdet_tpu_torch.train.trainer import build_trainer
    out, names = {}, None
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            for way in ('host', 'device'):
                with (device_books_on() if way == 'device'
                      else contextlib.nullcontext()):
                    trainer = build_trainer(cfg, dev, seed=0, total_steps=2)
                    batch = trainer.make_batch(pts, mask, gt)
                    parta2_gt_proposals(trainer.model, batch['gt_boxes'])
                    sync()
                    reset_launches()
                    reset_overlap()
                    loss, tb, grads = train_state.loss_and_grads(
                        trainer.model, list(trainer.state.params), batch)
                    sync()
                    out[way] = (loss, tb, grads, batch['books'],
                                nonzero(all_launches()),
                                overlap_launches())
                    names = trainer.state.optimizer.names
                    del trainer, batch
    finally:
        torch.use_deterministic_algorithms(False)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    warned = sorted({str(w.message).split('\n')[0][:160] for w in caught
                     if 'deterministic' in str(w.message)})
    return out, names, warned


def run_device_books(dev, smi):
    """Phases K1-K3; returns the launches by path {name: {path: n}}."""
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.models.backbones3d import SparseBottleneck
    from pcdet_tpu_torch.models.layers import init_weights
    from pcdet_tpu_torch.ops import sparse
    from pcdet_tpu_torch.train.trainer import make_train_scans
    paths = {'gather_gemm_bf16': {}, 'rotated_overlap': {}, 'nms_fused': {},
             'gather_gemm_f32': {}, 'gather_dw': {}, 'gather_dw_seg': {}}
    print('[books K] %s' % smi)

    # K1. SECOND at full width, B2 and B8 ----------------------------------
    t0 = time.perf_counter()
    cfg = detect_mod.load_config(detect_mod.SECOND_CFG)
    det = second_detector(cfg, dev)
    caps = {False: det.max_voxels,
            True: int(cfg.DATA_CONFIG.TRAIN.MAX_NUMBER_OF_VOXELS)}
    pts_np, mask_np = detect_mod.make_scans(cfg, 8)
    pts8 = torch.as_tensor(pts_np, device=dev)
    mask8 = torch.as_tensor(mask_np, device=dev)
    level2 = None
    for b in (2, 8):
        pts, mask = pts8[:b].contiguous(), mask8[:b].contiguous()
        for train in (False, True):
            det.max_voxels = caps[train]
            vox = det.voxelize(pts, mask)
            got = books_both_ways('[books K1] second.yaml B%d' % b, det,
                                  vox['coordinates'], train)
            if b == 2 and not train:
                level2 = got
        det.max_voxels = caps[False]
        counts, a, f = detect_both_ways('[books K1] second.yaml', det, pts,
                                        mask)
        require(counts.get('gather_gemm_bf16', 0) > 0 and f > 0,
                'K1: detect launched %s, kernel F %d' % (counts, f))
        if b == 2:
            path = 'second detect B2, device books (K1)'
            paths['gather_gemm_bf16'][path] = counts.get('gather_gemm_bf16',
                                                         0)
            paths['rotated_overlap'][path] = a
            paths['nms_fused'][path] = f
    print('[books K1] %.1f s' % (time.perf_counter() - t0))
    mark('K1')

    # K3. SparseBottleneck and sparse_maxpool3d on K1's conv2 level --------
    t0 = time.perf_counter()
    ids, coords, mask, _, _ = level2['spconv2']
    shape = sparse.conv_out_shape(det.model.sparse_shape, 3, 2, 1)
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(*mask.shape, 16, generator=gen).to(dev)
    level = sparse.SparseLevel(feats * mask[..., None], ids, coords, mask,
                               shape)
    cpu_level = sparse.SparseLevel(*(t.cpu() for t in level[:4]), shape)
    require(torch.equal(sparse.subm_rules(level), level2['subm2']),
            'K3: subm_rules of the conv2 level is not its subm2 book')
    net = SparseBottleneck(16, 16)
    init_weights(net, gen)
    for bn in (m for m in net.modules() if hasattr(m, 'running_var')):
        bn.running_mean.copy_(torch.rand(bn.running_mean.shape,
                                         generator=gen) * 0.2 - 0.1)
        bn.running_var.copy_(torch.rand(bn.running_var.shape,
                                        generator=gen) + 0.5)
    card = copy.deepcopy(net).to(dev)
    for train in (False, True):
        net.train(train)
        card.train(train)
        with torch.no_grad():
            reset_launches()
            out = card(level, level2['subm2'])
            sync()
            counts = nonzero(all_launches())
            want = net(cpu_level)
        err = (out.features.cpu() - want.features).abs().max().item()
        scale = want.features.abs().max().item()
        print('[books K3] SparseBottleneck(16, 16) %s on the conv2 level of '
              'K1\'s B2 scans (%s live rows of %d, 16 -> 16 -> 16 -> 64, '
              'projection 16 -> 64): launches %s; max |card - CPU| %.3g of '
              'max |out| %.3g' % ('train' if train else 'eval',
                                  mask.sum(1).tolist(), mask.shape[1],
                                  counts, err, scale))
        require(counts.get('gather_gemm_f32', 0) == 4,
                'K3: SparseBottleneck launched %s, want 4 of B' % counts)
        require(scale > 0 and err <= 1e-5 * scale,
                'K3: SparseBottleneck card vs CPU %g of %g' % (err, scale))
        if not train:
            paths['gather_gemm_f32'][
                'SparseBottleneck on the conv2 level B2 (K3)'] = counts.get(
                    'gather_gemm_f32', 0)
    cap = level2['spconv3'][0].shape[1]
    pooled = sparse.sparse_maxpool3d(level, 3, 2, 1, cap)
    want = sparse.sparse_maxpool3d(cpu_level, 3, 2, 1, cap)
    pool_ms = cuda_ms(lambda: sparse.sparse_maxpool3d(level, 3, 2, 1, cap), 5)
    err = (pooled.features.cpu() - want.features).abs().max().item()
    scale = want.features.abs().max().item()
    for a, b in zip(pooled[1:4], want[1:4]):
        require(torch.equal(a.cpu(), b), 'K3: max-pool output set differs')
    require(torch.equal(pooled.ids, level2['spconv3'][0]),
            'K3: the max-pool output set is not spconv3\'s')
    require(scale > 0 and err <= 1e-5 * scale,
            'K3: sparse_maxpool3d card vs CPU %g of %g' % (err, scale))
    print('[books K3] sparse_maxpool3d 3 / 2 / 1 at cap %d: output set == '
          'spconv3\'s book, max |card - CPU| %.3g of %.3g, %.2f ms a call'
          % (cap, err, scale, pool_ms))
    del det, level, card
    print('[books K3] %.1f s' % (time.perf_counter() - t0))
    mark('K3')

    # K2. Part-A² at full width, B2 ----------------------------------------
    t0 = time.perf_counter()
    cfg = detect_mod.load_config(detect_mod.PARTA2_CFG)
    det = second_detector(cfg, dev)
    pts_np, mask_np, gt_np = make_train_scans(cfg, 2, ring_keep=0.35)
    pts = torch.as_tensor(pts_np, device=dev)
    mask = torch.as_tensor(mask_np, device=dev)
    caps = {False: det.max_voxels,
            True: int(cfg.DATA_CONFIG.TRAIN.MAX_NUMBER_OF_VOXELS)}
    for train in (False, True):
        det.max_voxels = caps[train]
        books_both_ways('[books K2] PartA2.yaml B2', det,
                        det.voxelize(pts, mask)['coordinates'], train)
    det.max_voxels = caps[False]
    counts, a, f = detect_both_ways('[books K2] PartA2.yaml', det, pts, mask)
    require(counts.get('gather_gemm_bf16', 0) > 0 and f > 0,
            'K2: detect launched %s, kernel F %d' % (counts, f))
    path = 'parta2 detect B2, device books (K2)'
    paths['gather_gemm_bf16'][path] = counts.get('gather_gemm_bf16', 0)
    paths['rotated_overlap'][path] = a
    paths['nms_fused'][path] = f
    with device_books_on():
        n = geometric_decoder_equal(det, pts, mask)
    print('[books K2] PartA2.yaml B2 eval forward with the inverse convs\' '
          'books withheld (geometric inverse rules): %d outputs bitwise '
          'equal to key reuse' % n)
    del det
    runs, names, warned = step_both_ways(cfg, dev, pts, mask, gt_np)
    (hl, htb, hg, hb, hc, ha), (dl, dtb, dg, db, dc, da) = (runs['host'],
                                                            runs['device'])
    books_equal('[books K2] train step', db, hb)
    require(hc == dc and ha == da, 'K2 step launches %s / %s with host '
            'books, %s / %s with device books' % (hc, ha, dc, da))
    require(torch.equal(dl, hl), 'K2 step loss %r vs %r' % (float(dl),
                                                          float(hl)))
    require(sorted(dtb) == sorted(htb), 'K2 step tb keys')
    for k, v in htb.items():
        require(torch.equal(dtb[k], v), 'K2 step %s differs' % k)
    apart = []
    for name, g, h in zip(names, dg, hg):
        if not torch.equal(g, h):
            apart.append((name, (g - h).abs().max().item()
                          / max(h.abs().max().item(), 1e-30)))
    print('[books K2] PartA2.yaml train step B2 (f32, TF32 off, '
          'deterministic algorithms): loss %.6f equal on host and device '
          'books, %d tb scalars equal, %d of %d gradients bitwise equal%s; '
          'launches %s, kernels A and F %s; ops warned of as '
          'nondeterministic: %s'
          % (float(hl), len(htb), len(names) - len(apart), len(names),
             ', the rest within %s of their max' % apart if apart else '',
             dc, da, warned or 'none'))
    require(all(r <= 1e-5 for _, r in apart) and (not apart or warned),
            'K2 step gradients differ: %s (ops warned of: %s)'
            % (apart, warned))
    path = 'parta2 train step B2, device books (K2)'
    paths['gather_gemm_f32'][path] = (dc.get('gather_gemm_f32', 0)
                                      + dc.get('gather_gemm_f32_dgrad', 0))
    paths['gather_dw'][path] = dc.get('gather_dw', 0)
    paths['gather_dw_seg'][path] = dc.get('gather_dw_seg', 0)
    paths['rotated_overlap'][path], paths['nms_fused'][path] = da
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    print('[books K2] %.1f s' % (time.perf_counter() - t0))
    mark('K2')
    return paths


def build_all():
    """Build every kernel (one nvcc each), the KITTI evaluator and the host
    book builder, all at once; returns the host book builder's library
    (None where g++ failed)."""
    from pcdet_tpu_torch.datasets.kitti.kitti_eval import (
        native as kitti_native)
    from pcdet_tpu_torch.ops import host_books
    from pcdet_tpu_torch.ops import gather_dw as gd
    from pcdet_tpu_torch.ops import gather_gemm as gg
    from pcdet_tpu_torch.ops import gather_xwin as gx
    from pcdet_tpu_torch.ops import rotated_overlap as ro
    builds = (ro.build, ro.build_sorted, gg.build, gd.build, gx.build,
              gd.build_xwin, kitti_native.get_lib, host_books.native_lib)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        jobs = [pool.submit(fn) for fn in builds]
        return [j.result() for j in jobs][-1]


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port is checked on the GPU',
              file=sys.stderr)
        return 2

    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.ops import cuda_build, host_books, nms, rotated_iou
    from pcdet_tpu_torch.ops import nms_fused as nf
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
    t_start = t0 = time.perf_counter()
    native_lib = build_all()
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

    # 3. full-width detect at B2 through the kernels ----------------------
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
    reset_overlap()
    preds = det.detect(pts2, mask2)
    sync()
    launches_b2, f_b2 = overlap_launches()
    num = preds['num'].tolist()
    print('[detect B2] num %s, kernel F launches (one per NMS call) %d, '
          'kernel A %d' % (num, f_b2, launches_b2))
    require(f_b2 > 0, 'the detect path launched no kernel F')
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

    # 4. NMS indices: kernel F vs the plain eager rounds, same candidates -
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
            'NMS indices differ between kernel F and the plain eager rounds')
    require(torch.equal(sel_c, sel_k) and torch.equal(num_c, num_k),
            'NMS indices differ with the counting launch')
    print('[nms] kernel F and the plain eager rounds select the same '
          'indices: num %s, valid candidates %s' % (
              num_k.tolist(), cand['valid'].sum(1).tolist()))
    print('[nms] kernel A, pairs kept (not culled) per eager NMS round of the '
          'B2 detect (count, share of the round\'s pairs): %s' % ', '.join(
              '%d of %d (%.2f%%)' % (c, n, 100 * c / n)
              for c, _, n in nms_rounds))
    require(all(c == k for c, k, _ in nms_rounds), 'kernel A\'s count of '
            'pairs kept differs from the plain predicate\'s in an NMS '
            'round: %s' % nms_rounds)

    # 4b. kernel F against the plain eager rounds at the B2 and B8 shapes --
    thresh = float(tc.NMS_THRESH)
    f_times = {}
    with torch.inference_mode():
        cands = {2: cand, 8: candidates(det.model, det.model.forward(
            det.voxelize(pts8, mask8)), tc)}
        for b, cb in cands.items():
            sel_f, num_f = run_nms(cb, tc)
            sel_e, num_e = run_nms(cb, tc, ro.pair_overlap_batched_plain)
            sync()
            require(torch.equal(sel_f, sel_e) and torch.equal(num_f, num_e),
                    'B%d: NMS indices differ between kernel F and the plain '
                    'eager rounds' % b)
            geo, area, valid = fused_inputs(cb, tc)
            keep, rounds = nf.greedy(geo, area, valid, thresh, post, True)
            f_ms, f_host = queued_ms(lambda: nf.greedy(
                geo, area, valid, thresh, post, True), 100)
            e_ms = cuda_ms(lambda: run_nms(cb, tc,
                                           ro.pair_overlap_batched_plain), 3)
            f_times[b] = {'ms': f_ms, 'plain_ms': e_ms,
                          'work': fused_work(geo, area, valid)}
            plan = nf.plan(geo.shape[1], True)
            print('[nms F B%d] G=%d pre=%d: indices equal to the plain eager '
                  'rounds (num %s); device rounds a group %s; kernel F %.4f '
                  'ms (queued behind a spin kernel; 100 calls enqueued in '
                  '%.2f ms), the plain eager rounds %.4f ms a call, bound '
                  '%.5f ms (%s); plan: %d CTAs a cluster, %d columns, %d B '
                  'of shared memory' % (
                      b, geo.shape[0], geo.shape[1], num_f.tolist(),
                      rounds.tolist(), f_ms, f_host, e_ms,
                      *bound_ms(*f_times[b]['work']), *plan))
            require(torch.equal(keep.sum(1).clamp(max=post).to(num_f.dtype),
                                num_f), 'B%d: kernel F alone keeps %s, '
                    'nms_bev_batched %s' % (b, keep.sum(1).tolist(),
                                            num_f.tolist()))

    # 5. whole detect at B1, f32: GPU vs CPU ------------------------------
    cfg32 = copy.deepcopy(cfg)
    cfg32.MODEL.RPN.RPN_HEAD.ARGS['compute_dtype_test'] = ''
    outs = {}
    for name, d in (('gpu', dev), ('cpu', torch.device('cpu'))):
        det32 = detect_mod.build_detector(cfg32, d, seed=0)
        with torch.no_grad():
            det32.model.module.rpn_head.conv_cls.bias.zero_()
        t0 = time.perf_counter()
        reset_overlap()
        outs[name] = {k: v.cpu() for k, v in det32.detect(
            pts8[:1].to(d), mask8[:1].to(d)).items()}
        if name == 'gpu':
            sync()
            # kernel A at G = 1 (A'): none since F runs the NMS
            g1_launches, g1_f = overlap_launches()
        print('[gpu vs cpu] %s detect B1 f32: %.2f s' % (
            name, time.perf_counter() - t0))
        del det32
    sync()
    g, c = outs['gpu'], outs['cpu']
    n_g, n_c = int(g['num'][0]), int(c['num'][0])
    box_err = (g['boxes'] - c['boxes']).abs().max().item()
    print('[gpu vs cpu] num %d vs %d, max |box diff| %.3g; kernel F launches '
          'at G = 1 %d, kernel A (A\') %d' % (n_g, n_c, box_err, g1_f,
                                              g1_launches))
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

    f_by_batch = {}
    for b in (2, 8):
        pts, mask = pts8[:b].contiguous(), mask8[:b].contiguous()
        det.detect(pts, mask)
        sync()
        reset_overlap()
        det.detect(pts, mask)
        sync()
        launches_f = overlap_launches()[1]
        f_by_batch[b] = launches_f
        rounds = nms.last_device_rounds().tolist()
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
              'kernel F launches %d, its device rounds a group %s' % (
                  b, 1e3 * b / ms, ', '.join('%.2f' % x for x in batch_ms),
                  split['voxelize'], split['model'], split['predict'],
                  split['topk_decode'], split['nms'], launches_f, rounds))
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
        for kname in ('nms_fused_kernel', 'rotated_overlap'):
            t = sum(t for t, name in rows if kname in name)
            print('[profile B%d] %s: %.3f ms per batch (%.1f%% of device '
                  'time)' % (b, kname, t, 100 * t / busy))
    sync()

    def timed(tag, fn, *args):
        t0 = _MARK[0] = time.perf_counter()
        out = fn(*args)
        mark('the rest of ' + tag)
        print('[time] %s: %.1f s' % (tag, time.perf_counter() - t0))
        return out

    print('[time] build and PointPillar phases 1-6: %.1f s'
          % (time.perf_counter() - t_start))
    second = timed('SECOND S1-S5', run_second, dev,
                   detect_mod.load_config(detect_mod.SECOND_CFG))
    dw_entry, b_train = timed('training T1-T5', run_train, dev,
                              detect_mod.load_config(detect_mod.SECOND_CFG))
    second[0].update(b_train)
    xwin = timed('load strategies X1-X4', run_xwin, dev,
                 detect_mod.load_config(detect_mod.SECOND_CFG))
    require(g1_f > 0, 'the B1 detect launched no kernel F')
    evals = timed('evaluation V1-V4', run_eval, dev, g1_launches, {
        'second.yaml': eval_config(detect_mod.SECOND_CFG),
        'pointpillar.yaml': eval_config(detect_mod.DEFAULT_CFG)})
    pp_eval_a, pp_eval_f = timed('PointPillar training P1-P4',
                             run_pointpillar_train, dev,
                             detect_mod.load_config())
    fork_paths = timed('BEVSEG fork F1-F4', run_fork, dev, smi)
    parta2_entries, parta2_paths = timed('Part-A2 R1-R3', run_parta2, dev)
    train_entries, train_paths = timed('Part-A2 training R5-R7',
                                       run_parta2_train, dev)
    books_paths = timed('device books K1-K3', run_device_books, dev, smi)
    with tempfile.TemporaryDirectory() as workdir:
        cli_paths = timed('CLI pair L1-L4, R8 and R4', run_cli, dev,
                          workdir)
        t_ddp = time.perf_counter()
        ddp_paths = timed('data-parallel M1-M2', run_ddp, dev)
        for name, by_path in timed('data-parallel M3', run_ddp_cli, dev,
                                   workdir).items():
            ddp_paths.setdefault(name, {}).update(by_path)
        for name, by_path in timed('every card M4', run_multi_card,
                                   workdir).items():
            ddp_paths.setdefault(name, {}).update(by_path)
        print('[time] data-parallel M1-M4: %.1f s'
              % (time.perf_counter() - t_ddp))

    a_entry = kernel_entry(
        'rotated_overlap', 'pcdet_tpu_torch/csrc/rotated_overlap.cu',
        'pcdet_tpu/ops/pallas/rotated_overlap.py:280', launches_b2,
        max_abs_err, kernel_ms, plain_ms, a_work)
    a_entry['launches_by_path'] = {
        'pointpillar detect B2': launches_b2,
        'pointpillar trained checkpoint eval B2 (P4)': pp_eval_a}
    # kernel F at the B8 NMS shape (the benchmark's) and at B2, each against
    # the plain eager rounds on the same candidates; it replaces no TPU
    # kernel
    f_entry, f_b2_entry = (kernel_entry(
        name, 'pcdet_tpu_torch/csrc/nms_fused.cu', None, n, 0.0,
        f_times[b]['ms'], f_times[b]['plain_ms'], f_times[b]['work'])
        for name, b, n in (('nms_fused', 8, f_by_batch[8]),
                           ('nms_fused_b2', 2, f_b2)))
    f_entry['launches_by_path'] = {
        'pointpillar detect B8': f_by_batch[8],
        'pointpillar detect B2': f_b2,
        'pointpillar detect B1 f32 (phase 5)': g1_f,
        'pointpillar trained checkpoint eval B2 (P4)': pp_eval_f}
    kernels = ([a_entry, f_entry, f_b2_entry] + second + [dw_entry] + xwin
               + parta2_entries + train_entries + evals)
    for entry in kernels:
        for paths in (parta2_paths, train_paths, cli_paths, ddp_paths,
                      books_paths, fork_paths):
            if entry['name'] in paths:
                entry.setdefault('launches_by_path', {}).update(
                    paths[entry['name']])
    print('[time] the whole script: %.1f s' % (time.perf_counter() - t_start))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
