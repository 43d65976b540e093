"""Profiling and tracing hooks: the port's counterpart of
`pcdet_tpu.utils.profiler`.

- `trace(logdir)`: a context manager over `torch.profiler.profile`.  It
  records host (CPU) activity always and CUDA activity where a card is
  present, and on exit writes a Chrome trace,
  `<host>_<pid>.<ms>.pt.trace.json`, into `logdir` (view it in Perfetto,
  chrome://tracing or TensorBoard's profiler plugin).  It yields the
  profiler, whose `key_averages()` sum the time by op and kernel.
- `StepTimer`: a rolling step-time and examples/s meter over the last
  `window` steps, `pcdet_tpu`'s API and arithmetic on the host clock
  (`time.perf_counter`).  CUDA launches return before the card finishes,
  so the caller synchronises (`torch.cuda.synchronize()`, or a fetch of a
  result) before `toc`, as JAX's callers block on a result.
"""
import contextlib
import time

import torch


@contextlib.contextmanager
def trace(logdir):
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


class StepTimer:
    def __init__(self, window=50):
        self.window = window
        self.times = []
        self.counts = []
        self._last = None

    def tic(self):
        self._last = time.perf_counter()

    def toc(self, n_examples=1):
        if self._last is None:
            return
        dt = time.perf_counter() - self._last
        self.times.append(dt)
        self.counts.append(n_examples)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.counts.pop(0)
        self._last = None

    @property
    def sec_per_step(self):
        return sum(self.times) / max(len(self.times), 1)

    @property
    def examples_per_sec(self):
        t = sum(self.times)
        return sum(self.counts) / t if t > 0 else 0.0

    @property
    def sec_per_example(self):
        n = sum(self.counts)
        return sum(self.times) / n if n > 0 else 0.0
