"""Device ms a batch of the kernels that the RPN's convolution ops
launch (cuDNN: forward), from the traced slice."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from benchmark.harness import trace  # noqa: E402

UNIT = 'ms'


def read(summary):
    if summary['entry'] != 'detect':
        return None
    t = trace.conv_op_s(summary)
    if t <= 0:
        return None
    return 1e3 * t / summary['batches']
