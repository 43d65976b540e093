"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: PointPillar detect.

    python3 chip_smoke.py

Drives `pcdet_tpu_torch`'s main path, raw scan to boxes, at the full width
of the shipped `tools/cfgs/pointpillar.yaml` (batch 2, 65536 points per
scan, 40000 voxels, a 432 x 496 x 64 canvas, 321,408 anchors, NMS 4096 ->
500) with random weights from a seed.  Phases, each fatal on failure:

  1. build the rotated-overlap kernel from csrc/ with nvcc (sm_90a);
  2. kernel vs its plain PyTorch version on the card, at the NMS shape
     (G=2, M=64, N=4096) and on crafted boxes (bound 1e-5 abs);
  3. full-width detect at B2 through the kernel (launch count > 0, num > 0);
  4. NMS indices with the kernel == with the plain version, same candidates;
  5. the whole detect at B1 in f32: GPU vs CPU (counts equal, boxes 1e-3);
  6. timings: detect frames/s at B2 and B8, the voxelize / model / predict
     split (predict as top-k + decode and NMS), the NMS round count, a
     torch.profiler breakdown by kernel and by op; the kernel beside the
     plain version comes from phase 2.

Prints the card's name and power limit, a JSON line with the kernels, and
as its last line {"ok": true, "device": {...}}.  Exits nonzero, with no
result line, when no CUDA device is present or any phase fails.
"""
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch


def require(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


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


def rand_boxes5(rng, shape, spread=30.0):
    cx = rng.uniform(-spread, spread, shape)
    cy = rng.uniform(-spread, spread, shape)
    w = rng.uniform(0.5, 5.0, shape)
    l = rng.uniform(0.5, 7.0, shape)
    ang = rng.uniform(-np.pi, np.pi, shape)
    return np.stack([cx - w / 2, cy - l / 2, cx + w / 2, cy + l / 2, ang],
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


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port is checked on the GPU',
              file=sys.stderr)
        return 2

    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.models import detector3d
    from pcdet_tpu_torch.ops import cuda_build, nms, rotated_iou
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

    # 1. build ------------------------------------------------------------
    ro.build()
    log = cuda_build.BUILD_LOG['rotated_overlap']
    print('[build] rotated_overlap.cu: %.2f s (cached=%s)'
          % (log['seconds'], log['cached']))
    for line in log['ptxas'].splitlines():
        if 'registers' in line or 'spill' in line:
            print('[build] ptxas:', line.strip())

    # 2. kernel vs plain, on the card -------------------------------------
    rng = np.random.RandomState(0)
    corners_b = rotated_iou.boxes5_to_corners(
        torch.as_tensor(rand_boxes5(rng, (2, 4096)), device=dev)).contiguous()
    corners_a = corners_b[:, :64].contiguous()      # includes identical pairs
    got = ro.pair_overlap_batched(corners_a, corners_b)
    want = ro.pair_overlap_batched_plain(corners_a, corners_b)
    sync()
    err_nms = (got - want).abs().max().item()
    bitwise = bool(torch.equal(got, want))
    ca, cb = crafted_boxes5()
    ca = rotated_iou.boxes5_to_corners(torch.as_tensor(ca, device=dev))
    cb = rotated_iou.boxes5_to_corners(torch.as_tensor(cb, device=dev))
    got_c = ro.pair_overlap(ca.contiguous(), cb.contiguous())
    want_c = ro.pair_overlap_batched_plain(ca[None], cb[None])[0]
    sync()
    err_crafted = (got_c - want_c).abs().max().item()
    expect = {(0, 0): 4.0, (1, 1): 0.0, (2, 2): 0.0, (3, 3): 100.0,
              (4, 4): 100.0, (5, 5): 8.0}
    for (i, j), v in expect.items():
        require(abs(got_c[i, j].item() - v) < 1e-3 * max(v, 1.0),
                'crafted pair (%d, %d): %r, want %r' % (i, j,
                                                        got_c[i, j].item(), v))
    max_abs_err = max(err_nms, err_crafted)
    print('[kernel] max |kernel - plain|: NMS shape %.3g, crafted %.3g; '
          'bitwise equal at NMS shape: %s' % (err_nms, err_crafted, bitwise))
    require(max_abs_err <= 1e-5, 'kernel disagrees with plain: %g'
            % max_abs_err)
    kernel_ms = cuda_ms(lambda: ro.pair_overlap_batched(corners_a, corners_b),
                        200)
    plain_ms = cuda_ms(
        lambda: ro.pair_overlap_batched_plain(corners_a, corners_b), 20)
    print('[kernel] G=2 M=64 N=4096: kernel %.4f ms, plain %.4f ms'
          % (kernel_ms, plain_ms))
    sync()

    # 3. full-width detect at B2 through the kernel -----------------------
    cfg = detect_mod.load_config()
    tc = cfg.MODEL.TEST
    pre = int(tc.NMS_PRE_MAXSIZE_LAST)
    post = int(tc.NMS_POST_MAXSIZE_LAST)
    det = detect_mod.build_detector(cfg, dev, seed=0)

    def candidates(ret):
        """predict's class-agnostic masked top-k and decode, before NMS."""
        b, a = ret['cls_preds'].shape[0], det.model.anchors.shape[0]
        return detector3d.topk_decode(
            ret['cls_preds'].reshape(b, a, -1).amax(-1),
            ret['box_preds'].reshape(b, a, -1),
            ret['dir_cls_preds'].reshape(b, a, -1), det.model.anchors,
            det.model.box_coder, det.model.head_args,
            float(tc.SCORE_THRESH), pre)

    def run_nms(cand, overlap_fn=ro.pair_overlap_batched):
        return nms.nms_bev_batched(
            cand['boxes5'], cand['rank'], float(tc.NMS_THRESH), pre_max=pre,
            post_max=post, valid_mask=cand['valid'], overlap_fn=overlap_fn)

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
        cand = candidates(det.model.forward(det.voxelize(pts2, mask2)))
        sel_k, num_k = run_nms(cand)
        sel_p, num_p = run_nms(cand, ro.pair_overlap_batched_plain)
    sync()
    require(torch.equal(sel_k, sel_p) and torch.equal(num_k, num_p),
            'NMS indices differ between kernel and plain')
    print('[nms] kernel and plain select the same indices: num %s, '
          'valid candidates %s' % (num_k.tolist(),
                                   cand['valid'].sum(1).tolist()))

    # 5. whole detect at B1, f32: GPU vs CPU ------------------------------
    cfg32 = copy.deepcopy(cfg)
    cfg32.MODEL.RPN.RPN_HEAD.ARGS['compute_dtype_test'] = ''
    outs = {}
    for name, d in (('gpu', dev), ('cpu', torch.device('cpu'))):
        det32 = detect_mod.build_detector(cfg32, d, seed=0)
        with torch.no_grad():
            det32.model.module.rpn_head.conv_cls.bias.zero_()
        t0 = time.perf_counter()
        outs[name] = {k: v.cpu() for k, v in det32.detect(
            pts8[:1].to(d), mask8[:1].to(d)).items()}
        print('[gpu vs cpu] %s detect B1 f32: %.2f s' % (
            name, time.perf_counter() - t0))
        del det32
    sync()
    g, c = outs['gpu'], outs['cpu']
    n_g, n_c = int(g['num'][0]), int(c['num'][0])
    box_err = (g['boxes'] - c['boxes']).abs().max().item()
    print('[gpu vs cpu] num %d vs %d, max |box diff| %.3g' % (n_g, n_c,
                                                             box_err))
    require(n_g == n_c, 'GPU and CPU detection counts differ')
    require(box_err <= 1e-3, 'GPU and CPU boxes differ by %g' % box_err)

    # 6. timings ------------------------------------------------------------
    def stage_ms(points, mask, iters):
        t = {}
        with torch.inference_mode():
            vox = det.voxelize(points, mask)
            ret = det.model.forward(vox)
            cand = candidates(ret)
            t['voxelize'] = cuda_ms(lambda: det.voxelize(points, mask), iters)
            t['model'] = cuda_ms(lambda: det.model.forward(vox), iters)
            t['predict'] = cuda_ms(lambda: det.model.predict(ret), iters)
            t['topk_decode'] = cuda_ms(lambda: candidates(ret), iters)
            t['nms'] = cuda_ms(lambda: run_nms(cand), iters)
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

    print(json.dumps({'kernels': [{
        'name': 'rotated_overlap',
        'route': 'cuda',
        'source': 'pcdet_tpu_torch/csrc/rotated_overlap.cu',
        'replaces': 'pcdet_tpu/ops/pallas/rotated_overlap.py:280',
        'launches': launches_b2,
        'max_abs_err': max_abs_err,
        'ms': kernel_ms,
        'plain_ms': plain_ms,
    }]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
