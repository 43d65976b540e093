"""The whole train step's share of the card's peak: the operations the
batch needs (`harness/flops.py`), each class at its precision's peak,
over the slice's seconds a batch."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from benchmark.harness import flops  # noqa: E402

UNIT = '%'


def read(summary):
    if summary['entry'] != 'train' or not summary.get('ops'):
        return None
    return 100.0 * flops.least_seconds(summary['ops']) / summary['window_s']
