"""The traced slice: torch.profiler (CUPTI) over a few steady batches, and
its summary for the per-layer readers.

The harness opens the profiler itself and names its own calls with
`record_function` (`bench.batch`, `bench.upload`, `bench.detect`,
`bench.download`, `bench.step`); nothing is read from the program's spans.
Device time is the union of the kernel, copy and set intervals on the
card; idle is the rest of the slice's wall time, which the host clock
takes between two synchronisations.
"""
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .common import sync

CONV_OPS = ('aten::cudnn_convolution', 'aten::cudnn_convolution_transpose',
            'aten::convolution_backward')
SPARSE_KERNELS = ('gather_gemm', 'gather_dw', 'sum_partials',
                  'xwin_selectors')


def run_traced(fn, n):
    """Call fn(i) for i < n under the profiler; returns (profile, window
    seconds, results)."""
    sync()
    out = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            with record_function('bench.batch'):
                out.append(fn(i))
        sync()
        t1 = time.perf_counter()
    return prof, t1 - t0, out


def _union(intervals):
    total, merged = 0.0, []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        total += e - s
    return total, merged


def summarize(prof, window_s):
    """busy seconds, kernel and op device seconds, and the breakdown."""
    events = prof.events()
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    # a record_function range shows on the device timeline too, under its
    # host name: no kernel has the name of a host event
    host_names = {e.name for e in host}
    dev, kernels = [], {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in host_names:
            s, t = e.time_range.start, e.time_range.end
            dev.append((s, t))
            kernels[e.name] = kernels.get(e.name, 0.0) + (t - s) * 1e-6
    busy_us, merged = _union(dev)
    ops = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            continue
        t = getattr(e, 'self_device_time_total', None)
        if t is None:
            t = getattr(e, 'self_cuda_time_total', 0)
        if t > 0:
            ops[e.key] = ops.get(e.key, 0.0) + t * 1e-6
    gaps = []
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        gaps.append((s1 - e0, e0, s1))
    gaps.sort(reverse=True)
    idle = []
    for length, a, b in gaps[:10]:
        mid = (a + b) / 2
        inner = None
        for e in host:
            r = e.time_range
            if r.start <= mid <= r.end and (inner is None
                                            or r.start >= inner.time_range.start):
                inner = e
        idle.append([inner.name if inner is not None else 'host',
                     length * 1e-6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {'window_s': window_s, 'busy_s': busy_us * 1e-6,
            'kernel_s': kernels, 'op_s': ops,
            'breakdown': {'device_ops': [[short(k), v] for k, v in top],
                          'idle_gaps': idle}}


def short(name, width=120):
    """A kernel's name without its return type and parameter list, cut to
    `width` characters."""
    name = name.replace('(anonymous namespace)::', '')
    if not name.startswith('void '):
        return name[:width]
    name = name[5:]
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == '<'
        depth -= ch == '>'
        if ch == '(' and depth == 0:
            cut = i
            break
    return name[:cut][:width]


def sparse_kernel_s(summary):
    return sum(v for k, v in summary['kernel_s'].items()
               if any(p in k for p in SPARSE_KERNELS))


def conv_op_s(summary):
    return sum(v for k, v in summary['op_s'].items() if k in CONV_OPS)
