"""Detect frames/s of two checkouts of the port, in turns on one GPU.

    git archive REV | tar -x -C build/old      # (build/ is ignored by git)
    python3 detect_ab.py build/old [--pairs 2]

Runs the measurement in a subprocess from the root of each tree (its own
`pcdet_tpu_torch`, kernels built there), old / new / new / old for each
pair, and prints one JSON line per run: SECOND (`tools/cfgs/second.yaml`)
detect frames/s at B8 on `detect.make_scans(cfg, 8, ring_keep=0.35)` and
the host rulebook build of that batch in ms (median of 5), PointPillar
(`tools/cfgs/pointpillar.yaml`) detect frames/s at B2 and B8; random
weights from seed 0 with conv_cls's bias zeroed, as `chip_smoke.py` runs
them.  Frames/s is the median of 3 runs of 10 batches after a warm-up,
host clock around whole batches ending in a synchronise.  Needs a CUDA
device.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def frames_per_s(det, pts, mask, b):
    import torch
    det.detect(pts, mask)
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(10):
            det.detect(pts, mask)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0) / 10)
    return b * 1e3 / sorted(runs)[1]


def measure():
    """One tree's numbers; the tree is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from pcdet_tpu_torch import detect as d
    if not torch.cuda.is_available():
        raise SystemExit('detect_ab: no CUDA device')
    dev = torch.device('cuda')
    out = {'tree': os.getcwd()}
    for name, path, ring_keep, batches in (
            ('second', d.SECOND_CFG, 0.35, (8,)),
            ('pointpillar', d.DEFAULT_CFG, 1.0, (2, 8))):
        cfg = d.load_config(path)
        det = d.build_detector(cfg, dev, seed=0)
        with torch.no_grad():
            det.model.module.rpn_head.conv_cls.bias.zero_()
        p, m = d.make_scans(cfg, 8, ring_keep=ring_keep)
        pts = torch.as_tensor(p, device=dev)
        mask = torch.as_tensor(m, device=dev)
        for b in batches:
            out['%s_b%d_fps' % (name, b)] = frames_per_s(
                det, pts[:b].contiguous(), mask[:b].contiguous(), b)
        if name == 'second':
            coords = det.voxelize(pts, mask)['coordinates'].cpu().numpy()
            ms = []
            for _ in range(5):
                t0 = time.perf_counter()
                det.model.build_books(coords)
                ms.append(1e3 * (time.perf_counter() - t0))
            out['second_b8_book_build_ms'] = sorted(ms)[2]
        del det
        torch.cuda.empty_cache()
    print(json.dumps(out))


def main():
    if sys.argv[1:] == ['--one']:
        measure()
        return 0
    old = Path(sys.argv[1]).resolve()
    pairs = int(sys.argv[sys.argv.index('--pairs') + 1]) if (
        '--pairs' in sys.argv) else 2
    for _ in range(pairs):
        for tree in (old, HERE, HERE, old):
            proc = subprocess.run([sys.executable, str(HERE / 'detect_ab.py'),
                                   '--one'], cwd=tree, capture_output=True,
                                  text=True)
            if proc.returncode:
                sys.stderr.write(proc.stdout + proc.stderr)
                return proc.returncode
            print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
