"""Sparse conv kernels' (B-E', D, D', their partial sums and selectors)
share of their roofline in training (forward, feature and weight gradients): the least time of each launch's work
(`harness/roofline.py`, counted from the benchmark's own rules), summed,
over those kernels' device time.  Nothing where no such kernel ran."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from benchmark.harness import trace  # noqa: E402

UNIT = '%'


def read(summary):
    if summary['entry'] != 'train':
        return None
    t = trace.sparse_kernel_s(summary)
    if t <= 0 or summary.get('sparse_least_s', 0) <= 0:
        return None
    return 100.0 * summary['sparse_least_s'] / t
