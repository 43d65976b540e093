"""Profiling and tracing hooks.

- `span(name)`: a named range of the program's host timeline, recorded
  only while a `torch.profiler` is recording: then it is a
  `record_function(name)` range, on the profiler's clock, that the device
  trace shares (Kineto maps CUPTI's timestamps onto it), nested in the
  span that encloses it.  With no profiler recording it returns one
  shared no-op context: one attribute read, nothing allocated, nothing
  dispatched.  The program's spans are named `pcdet.*`: `pcdet.voxelize`,
  `pcdet.books`, `pcdet.vfe`, `pcdet.rpn`, `pcdet.predict`,
  `pcdet.nms.round`, `pcdet.forward`, `pcdet.backward`, `pcdet.optimizer`.
- `trace(logdir)`: the operator's exporter for those spans, a context
  manager over `torch.profiler.profile`.  It records host (CPU) activity
  always and CUDA activity where a card is present, and on exit writes a
  Chrome trace, `<host>_<pid>.<ms>.pt.trace.json`, into `logdir` (view it
  in Perfetto, chrome://tracing or TensorBoard's profiler plugin), where
  each span sits above the ops and kernels it launched.  It yields the
  profiler, whose `key_averages()` sum the time by op, kernel and span.
"""
import contextlib

import torch
from torch.autograd import profiler as autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name):
    # read through the module at each call: `torch.profiler.profile` sets
    # the flag on start and clears it on stop
    if autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
