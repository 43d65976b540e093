"""Entry `detect`: a closed loop of one stream of batches through
`build_detector(cfg, 'cuda', state_dict=...).detect`.

Set-up makes the weights from the seed (with the BN calibration), builds
the detector, makes the pool of scans in host memory (pinned) and runs
each pool batch once.  The window cycles through the pool's batches in a
seeded order: each batch is copied up from host memory, detected, and its
boxes, scores, labels and counts copied down; a batch's latency runs from
the start of its upload to its boxes in host memory.

Correctness (`check`): for a sample of the window's batches drawn from the
seed, the reference runs the same scans at the configuration's eval
precision (bf16 inputs and weights of the sparse and RPN convs, float32
sums, the RPN convs' outputs rounded to bf16; float32 elsewhere, TF32 off)
and the program's detections are held against it by these numbers, in a
distance between a served box and a reference anchor's decoded box, in
the head's own units (`distance`: positions over the anchor's size, log
size ratios, headings modulo pi, since a heading and its flip are one
box, and the raw logits of the served label):
  det_gap - the widest distance from a served detection to its nearest
      reference candidate (any anchor whose logit is near the served
      ones), so every served box is a box the reference predicts;
  set_gap - of the first TOP_N served detections of each scan, and of
      the first TOP_N of the reference's kept ones (both sides' NMS, in
      rank order), the share with no counterpart among the other side's
      within MATCH_TOL, the larger of the two shares: so the two NMS keep
      the same boxes, and no scan's answer goes missing.
A cell compares the numbers that its workload file gives a limit; the
others are printed beside them.
"""
import math
import time

import numpy as np
import torch

from ..harness import common, flops, scenes, trace
from ..reference import post, sparse as ref_sparse
from ..reference.anchors import Anchors
from ..reference.voxel import voxelize

MATCH_TOL = 0.1
# set_gap compares the first TOP_N detections of each scan on either side:
# past them, greedy NMS at SECOND's IoU 0.01 cascades one near-tie of rank
# into many different picks, and the share stops telling bf16 from float8
TOP_N = 100
KEYS = ('boxes', 'scores', 'labels', 'num')


class State:
    pass


def prepare(ctx):
    """The inputs both sides get: the pool's scans, and the weights from
    the seed with their BN calibration (on the device, and a host copy)."""
    w, ref = ctx.work, ctx.ref
    st = State()
    dev = st.device = ctx.device
    data = ctx.cfg.DATA_CONFIG
    names = ctx.cfg.CLASS_NAMES
    ids = scenes.scene_ids(ctx.seed, int(w['pool']), 0)
    st.points, st.mask, _ = scenes.make_pool(
        ids, names, w['scene'], int(data.MAX_POINTS), int(data.MAX_GT_BOXES))
    cal = scenes.scene_ids(ctx.seed, int(w['calibration_scans']), 1)
    cp, cm, _ = scenes.make_pool(cal, names, w['scene'],
                                 int(data.MAX_POINTS), int(data.MAX_GT_BOXES))
    ctx.stage('scenes')
    params = common.make_weights(ref.spec(), ctx.seed, dev)
    ctx.stage('weights')
    common.calibrate(ref, params, torch.as_tensor(cp, device=dev),
                     torch.as_tensor(cm, device=dev))
    st.weights = params
    st.params = {k: v.cpu() for k, v in params.items()}
    ctx.stage('calibration')
    st.batch = int(w['batch'])
    st.batches = len(ids) // st.batch
    return st


def setup(ctx):
    from pcdet_tpu_torch.detect import build_detector
    st = prepare(ctx)
    dev, b = st.device, st.batch
    st.det = build_detector(ctx.cfg, dev, state_dict=st.weights)
    del st.weights
    ctx.stage('build')
    pin = dev.type == 'cuda'
    st.host = [(_host(st.points[i:i + b], pin), _host(st.mask[i:i + b], pin))
               for i in range(0, st.batches * b, b)]
    ctx.stage('pin')
    common.reset_peak(dev)
    for i in range(len(st.host)):
        run_batch(st, i)
    common.sync()
    ctx.stage('warm-up')
    return st


def _host(a, pin):
    t = torch.from_numpy(a)
    return t.pin_memory() if pin else t


def run_batch(st, i):
    """Batch i of the pool, host to host: (outputs on the host, seconds)."""
    pts, msk = st.host[i]
    t0 = time.perf_counter()
    with trace.record_function('bench.upload'):
        p = pts.to(st.device, non_blocking=True)
        m = msk.to(st.device, non_blocking=True)
    with trace.record_function('bench.detect'):
        preds = st.det.detect(p, m)
    with trace.record_function('bench.download'):
        out = {k: preds[k].cpu() for k in KEYS}
    return out, time.perf_counter() - t0


def order(ctx, n):
    rng = np.random.default_rng([int(ctx.seed), 2])
    while True:
        yield from rng.permutation(n)


def window(st, ctx):
    """The measured window; returns (metrics, record of the batches)."""
    seq = order(ctx, len(st.host))
    lat, done = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        i = int(next(seq))
        out, dt = run_batch(st, i)
        lat.append(dt)
        done.append((i, out))
    wall = time.perf_counter() - t0
    ms = np.asarray(lat) * 1e3
    frames = len(done) * st.batch
    metrics = {'frames_per_s': (frames / wall, 'frames/s'),
               'batch_p95_ms': (float(np.percentile(ms, 95)), 'ms')}
    ctx.note('window: %d batches, %d frames in %.4f s; batch ms median '
             '%.4f p95 %.4f (n=%d)' % (len(done), frames, wall,
                                       float(np.median(ms)),
                                       float(np.percentile(ms, 95)),
                                       len(ms)))
    return metrics, done


def traced(st, ctx):
    """The traced slice and its work counts; returns (summary, record)."""
    seq = order(ctx, len(st.host))
    idx = [int(next(seq)) for _ in range(int(ctx.work['traced_batches']))]
    prof, wall, outs = trace.run_traced(lambda k: run_batch(st, idx[k]),
                                        len(idx))
    summary = trace.summarize(prof, wall)
    summary['batches'] = len(idx)
    ops, least = {}, 0.0
    for i in idx:
        o, s = batch_work(st, ctx, i)
        least += s
        for k, v in o.items():
            ops[k] = ops.get(k, 0) + v
    summary['ops'] = ops
    summary['sparse_least_s'] = least
    return summary, [(i, o[0]) for i, o in zip(idx, outs)]


def batch_work(st, ctx, i):
    """({precision: ops}, least sparse seconds) of pool batch i, counted
    by the reference's voxelization and rules at the eval caps."""
    ref = ctx.ref
    b = st.batch
    pts = torch.as_tensor(st.points[i * b:(i + 1) * b], device=ctx.device)
    msk = torch.as_tensor(st.mask[i * b:(i + 1) * b], device=ctx.device)
    work, pillars = [], 0
    with torch.no_grad():
        if ref.kind == 'second':
            vox = voxelize(pts, msk, ref.voxel_size, ref.pc_range,
                           ref.max_points, ref.caps['eval'])
            rule_work(ref, vox, b, False, work)
        else:
            vox = voxelize(pts, msk, ref.voxel_size, ref.pc_range,
                           ref.max_points, ref.caps['eval'])
            pillars = len(vox['coords'])
    return flops.batch_ops(ref, ctx.conf['precision']['eval'], work, pillars,
                           b, train=False)


def rule_work(ref, vox, batch, train, work):
    """The sparse encoder's per-conv counts over `vox`, features left out
    (one channel of zeros stands for them)."""
    from ..reference.net import SECOND_CONVS
    from ..reference.net import identity
    level = ref_sparse.Level(vox['coords'],
                             torch.zeros(len(vox['coords']), 1,
                                         device=vox['coords'].device),
                             ref.sparse_shape, batch)
    caps = ref.level_caps(train)
    stage = 0
    for name, cin, cout, kind in SECOND_CONVS:
        k = (3, 1, 1) if kind == 'out' else (3, 3, 3)
        w = torch.zeros((*k, 1, 1), device=level.coords.device)
        if kind is None:
            level = ref_sparse.subm_conv(level, w, identity, work, name)
        else:
            stride, pad = ((2, 1, 1), ref.last_pad) if kind == 'out' else kind
            level, _ = ref_sparse.strided_conv(level, w, stride, pad,
                                               caps[stage], identity, work,
                                               name)
            stage += 1
        work[-1]['cin'], work[-1]['cout'] = cin, cout


def free(st):
    st.det = None
    common.reset_peak(st.device, reset=False)


def distance(boxes, scores, cand):
    """(K, M) distance of served boxes (K, 7) and scores (K,) from
    reference candidates (their anchors, decoded boxes and logits), in the
    head's own units: x, y gaps over the anchor's BEV diagonal, the z gap
    over the larger of the anchor's and the candidate's height, the log
    ratios of the sizes, the heading gap modulo pi, the logit gap; the
    largest of them."""
    b, c, a = boxes[:, None], cand['boxes'][None], cand['anchors'][None]
    diag = torch.sqrt(a[..., 3] ** 2 + a[..., 4] ** 2)
    gaps = [torch.abs(b[..., 0] - c[..., 0]) / diag,
            torch.abs(b[..., 1] - c[..., 1]) / diag,
            torch.abs(b[..., 2] - c[..., 2]) / torch.maximum(
                a[..., 5], torch.abs(c[..., 5]))]
    gaps += [torch.abs(torch.log(b[..., k] / c[..., k])) for k in (3, 4, 5)]
    r = b[..., 6] - c[..., 6]
    gaps.append(torch.abs(r - math.pi * torch.round(r / math.pi)))
    gaps.append(torch.abs(scores[:, None] - cand['logits'][None]))
    return torch.stack(gaps, -1).amax(-1)


def nearest(boxes, scores, cand, chunk=16):
    """For each served box, its distance to the nearest candidate."""
    if len(cand['anchors']) == 0:
        return torch.full((len(boxes),), math.inf, device=boxes.device)
    out = [distance(boxes[s:s + chunk], scores[s:s + chunk], cand).amin(1)
           for s in range(0, len(boxes), chunk)]
    return torch.cat(out) if out else boxes.new_zeros(0)


def served(record):
    """Per scan of a record entry: (boxes, scores, labels) of the valid
    detections."""
    out = []
    for k in range(record['num'].shape[0]):
        n = int(record['num'][k])
        out.append((record['boxes'][k, :n].float(),
                    record['scores'][k, :n].float(),
                    record['labels'][k, :n].long()))
    return out


def compare(dets, refs, anchors):
    """{det_gap, set_gap} of served detections against reference runs of
    the same scans (`anchors`: the flat anchors, (A, 7))."""
    det_gap = 0.0
    missed = {'served': [0, 0], 'reference': [0, 0]}    # unmatched, total
    for (boxes, scores, labels), ref in zip(dets, refs):
        dev = ref['all_boxes'].device
        boxes, scores, labels = boxes.to(dev), scores.to(dev), labels.to(dev)
        if len(boxes):
            lo = float(scores.min()) - 1.0
            for c in labels.unique().tolist():
                logit = ref['all_logits'][:, c - 1]
                keep = logit >= lo
                cand = {'anchors': anchors[keep], 'boxes':
                        ref['all_boxes'][keep], 'logits': logit[keep]}
                sel = labels == c
                gap = nearest(boxes[sel], scores[sel], cand)
                det_gap = max(det_gap, float(gap.max()))
        a = ref['anchor']
        kept = {'anchors': anchors[a], 'boxes': ref['boxes'],
                'logits': ref['scores']}
        # each side's first TOP_N (both lists are in rank order) against
        # the whole of the other side
        n_s, n_r = min(len(boxes), TOP_N), min(len(a), TOP_N)
        near = torch.zeros((len(boxes), len(a)), dtype=torch.bool,
                           device=dev)
        if len(boxes) and len(a):
            near = torch.cat([distance(boxes[s:s + 16], scores[s:s + 16],
                                       kept) <= MATCH_TOL
                              for s in range(0, len(boxes), 16)])
        missed['served'][0] += int((~near[:n_s].any(1)).sum())
        missed['served'][1] += n_s
        missed['reference'][0] += int((~near.any(0)[:n_r]).sum())
        missed['reference'][1] += n_r
    set_gap = max(u / max(t, 1) for u, t in missed.values())
    return {'det_gap': det_gap, 'set_gap': set_gap}


def reference_runs(ctx, points, mask, lower=False):
    """The reference's detections of (B, P, 4) scans, in blocks, at the
    configuration's eval precision (`lower`: one step below, the
    control)."""
    from ..reference.net import precision
    prec = precision(ctx.conf['precision']['eval'], lower)
    ref = ctx.ref
    anchors = torch.as_tensor(Anchors(ref.cfg, ref.grid).anchors,
                              device=ctx.device)
    res = []
    with torch.no_grad(), common.exact_f32():
        for s in range(0, len(points), 4):
            out = ref.forward(ctx.params_dev, torch.as_tensor(
                points[s:s + 4], device=ctx.device), torch.as_tensor(
                mask[s:s + 4], device=ctx.device), train=False, prec=prec)
            res += post.detections(out, anchors, ref.cfg)
    return res


def sample(ctx, record):
    """Entries of the record to check: up to `checked_batches` of distinct
    pool batches, drawn from the seed, each its last run."""
    last = {}
    for i, out in record:
        last[i] = out
    keys = sorted(last)
    rng = np.random.default_rng([int(ctx.seed), 3])
    n = min(int(ctx.work['checked_batches']), len(keys))
    return [(k, last[k]) for k in rng.choice(keys, n, replace=False)]


def check(st, ctx, record):
    """{name: value} of the comparison with the reference."""
    ctx.params_dev = {k: v.to(ctx.device) for k, v in st.params.items()}
    b = st.batch
    dets, pts, msk = [], [], []
    for i, out in sample(ctx, record):
        dets += served(out)
        pts.append(st.points[i * b:(i + 1) * b])
        msk.append(st.mask[i * b:(i + 1) * b])
    refs = reference_runs(ctx, np.concatenate(pts), np.concatenate(msk))
    anchors = torch.as_tensor(Anchors(ctx.ref.cfg, ctx.ref.grid).anchors,
                              device=ctx.device)
    return compare(dets, refs, anchors)
