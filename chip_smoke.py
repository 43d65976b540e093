"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: PointPillar and
SECOND detect.

    python3 chip_smoke.py

Drives `pcdet_tpu_torch`'s main paths, raw scan to boxes, at the full width
of the shipped configs with random weights from a seed: PointPillar
(`tools/cfgs/pointpillar.yaml`: batch 2, 65536 points per scan, 40000
voxels, a 432 x 496 x 64 canvas, 321,408 anchors, NMS 4096 -> 500), then
SECOND (`tools/cfgs/second.yaml`: sparse shape 41 x 1600 x 1408, 25088
voxels, level caps 43520 / 29184 / 12288 / 10240, BEV 200 x 176 x 256,
211,200 anchors, NMS 4096 -> 500).  Phases, each fatal on failure:

  1. build every kernel from csrc/ with nvcc (sm_90a), and the host
     rulebook builder with g++, all at once;
  2. kernel vs its plain PyTorch version on the card, at the NMS shape
     (G=2, M=64, N=4096) and on crafted boxes (bound 1e-5 abs);
  3. full-width detect at B2 through the kernel (launch count > 0, num > 0);
  4. NMS indices with the kernel == with the plain version, same candidates;
  5. the whole detect at B1 in f32: GPU vs CPU (counts equal, boxes 1e-3);
  6. timings: detect frames/s at B2 and B8, the voxelize / model / predict
     split (predict as top-k + decode and NMS), the NMS round count, a
     torch.profiler breakdown by kernel and by op; the kernel beside the
     plain version comes from phase 2.
  S2. gather-GEMM kernels B (f32) and C (bf16) vs their plain versions on
      rules of the real B2 books at conv2_1 (K=27, 32 -> 32) and conv_out
      (K=3, 64 -> 128), with all-miss rows, n_live 0 and n_live mid-tile
      (bound 1e-5 * max |plain|), and their times;
  S3. shipped second.yaml detect at B2 through kernel C (launches > 0,
      num > 0), with the voxel count, voxelizer overflow and per-level drops;
  S4. the same config in f32 at B1 through kernel B: GPU vs CPU (counts
      equal, boxes 1e-3);
  S5. timings at B2 and B8: frames/s, the voxelize / books / backbone /
      RPN / predict split, ms per sparse conv, a torch.profiler breakdown.

Prints the card's name and power limit, a JSON line with the kernels, and
as its last line {"ok": true, "device": {...}}.  Exits nonzero, with no
result line, when no CUDA device is present or any phase fails.
"""
import concurrent.futures
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


def print_ptxas(name, log):
    """One line per library: registers and spills of each kernel instance
    as `nvcc -Xptxas -v` reports them."""
    regs, spills, entries = [], [], 0
    for line in log['ptxas'].splitlines():
        if 'Compiling entry function' in line:
            entries += 1
        elif 'spill stores' in line:
            spills.append(int(line.split('bytes spill stores')[0]
                              .split(',')[-1]))
        elif 'Used' in line and 'registers' in line:
            regs.append(int(line.split('Used')[1].split('registers')[0]))
    if not entries:
        print('[build] %s: ptxas report empty (library reused)' % name)
        return
    print('[build] %s: %d kernel instances, %d-%d registers, spill stores '
          '%d bytes at most (%d instances spill)' % (
              name, entries, min(regs), max(regs), max(spills),
              sum(1 for x in spills if x)))


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


def second_detector(cfg, dev):
    """SECOND with random weights from seed 0 and conv_cls's bias zeroed:
    the focal prior puts every score near 0.01, under SCORE_THRESH 0.3."""
    from pcdet_tpu_torch import detect as detect_mod
    det = detect_mod.build_detector(cfg, dev, seed=0)
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


def gather_gemm_vs_plain(dev, det, books):
    """S2: kernels B and C against their plain versions on the card, on
    the rules of real books at conv2_1 and conv_out.

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
                want = gg.gather_gemm_plain(table, rules, w, n_live)
                sync()
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
            ms = cuda_ms(lambda: gg.gather_gemm(table, rules, w, live), 20)
            plain_ms = cuda_ms(
                lambda: gg.gather_gemm_plain(table, rules, w, live), 3, 1)
            print('[second S2] %s %s (B=%d, V_out=%d, K=%d, %d -> %d, live %s):'
                  ' max |kernel - plain| %.3g (%.3g of max |plain| %.4g; '
                  'real, mid-tile %s and zero n_live); kernel %.4f ms, plain '
                  '%.4f ms' % (name, tag, b, v_out, k, cin, cout,
                               live.tolist(), err, err / scale, scale,
                               mid.tolist(), ms, plain_ms))
            if name == 'conv2_1':
                stats[tag] = {'err': err, 'rel': err / scale, 'ms': ms,
                              'plain_ms': plain_ms}
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


def run_second(dev, cfg, batches=(2, 8)):
    """Phases S1-S5 on SECOND; returns the kernels' JSON entries."""
    from pcdet_tpu import native
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.ops import cuda_build, sparse
    from pcdet_tpu_torch.ops import gather_gemm as gg
    tc = cfg.MODEL.TEST
    post = int(tc.NMS_POST_MAXSIZE_LAST)
    counts = gg.LAUNCHES

    # S1. build (started with the others in phase 1) ----------------------
    gg.build()
    log = cuda_build.BUILD_LOG['gather_gemm']
    print('[second S1] gather_gemm.cu: %.2f s (cached=%s)'
          % (log['seconds'], log['cached']))
    print_ptxas('gather_gemm.cu', log)

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

    # S3. shipped config (bf16 sparse stack) at B2 through kernel C --------
    det.detect(pts2, mask2)                          # warm-up
    sync()
    for k in counts:
        counts[k] = 0
    preds = det.detect(pts2, mask2)
    sync()
    launches_c, stray_b = counts['gather_gemm_bf16'], counts['gather_gemm_f32']
    num = second_detect_checks(preds, post, 2)
    with torch.inference_mode():
        ret = det.model.forward(dict(vox, books=books))
    drops = {k: v.tolist() for k, v in ret['overflow'].items()}
    print('[second S3] detect B2 (second.yaml, bf16 sparse stack): num %s; '
          'kernel C launches %d (12 convs per batch), kernel B %d; input '
          'voxels %s of cap %d, voxelizer overflow %s; per-level drops %s'
          % (num, launches_c, stray_b,
             vox['voxel_mask'].sum(1).tolist(), det.max_voxels,
             voxel_overflow(det, pts2, mask2), drops))
    require(launches_c > 0, 'the SECOND path launched no kernel C')
    require(stray_b == 0, 'the bf16 path launched kernel B')

    # S4. f32 config through kernel B: GPU vs CPU at B1 ---------------------
    cfg32 = copy.deepcopy(cfg)
    cfg32.MODEL.RPN.BACKBONE.ARGS['compute_dtype_test'] = ''
    cfg32.MODEL.RPN.RPN_HEAD.ARGS['compute_dtype_test'] = ''
    outs = {}
    for name, d in (('gpu', dev), ('cpu', torch.device('cpu'))):
        det32 = second_detector(cfg32, d)
        for k in counts:
            counts[k] = 0
        t0 = time.perf_counter()
        outs[name] = {k: v.cpu() for k, v in det32.detect(
            pts_all[:1].to(d), mask_all[:1].to(d)).items()}
        if name == 'gpu':
            sync()
            launches_b = counts['gather_gemm_f32']
            stray_c = counts['gather_gemm_bf16']
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
          % (native.get_lib() is not None))
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
        return {'name': 'gather_gemm_' + tag, 'route': 'cuda',
                'source': 'pcdet_tpu_torch/csrc/gather_gemm.cu',
                'replaces': replaces, 'launches': launches,
                'max_abs_err': kstats[tag]['err'], 'ms': kstats[tag]['ms'],
                'plain_ms': kstats[tag]['plain_ms']}
    return [entry('f32', launches_b,
                  'pcdet_tpu/ops/pallas/gather_gemm.py:700'),
            entry('bf16', launches_c,
                  'pcdet_tpu/ops/pallas/gather_gemm.py:659')]


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port is checked on the GPU',
              file=sys.stderr)
        return 2

    from pcdet_tpu import native
    from pcdet_tpu_torch import detect as detect_mod
    from pcdet_tpu_torch.ops import cuda_build, rotated_iou
    from pcdet_tpu_torch.ops import gather_gemm as gg
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
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(ro.build), pool.submit(gg.build),
                pool.submit(native.get_lib)]
        native_lib = [j.result() for j in jobs][2]
    print('[build] all builds: %.2f s wall; native host book builder: %s'
          % (time.perf_counter() - t0,
             'built' if native_lib is not None else 'MISSING (numpy path)'))
    log = cuda_build.BUILD_LOG['rotated_overlap']
    print('[build] rotated_overlap.cu: %.2f s (cached=%s)'
          % (log['seconds'], log['cached']))
    print_ptxas('rotated_overlap.cu', log)

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

    print(json.dumps({'kernels': [{
        'name': 'rotated_overlap',
        'route': 'cuda',
        'source': 'pcdet_tpu_torch/csrc/rotated_overlap.cu',
        'replaces': 'pcdet_tpu/ops/pallas/rotated_overlap.py:280',
        'launches': launches_b2,
        'max_abs_err': max_abs_err,
        'ms': kernel_ms,
        'plain_ms': plain_ms,
    }] + second}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
