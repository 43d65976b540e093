"""The program's spans in a traced slice, and the device time and idle
each one holds.

The port names its stages with `pcdet_tpu_torch.utils.profiler.span`
(`pcdet.voxelize`, `pcdet.vfe`, `pcdet.rpn`, `pcdet.predict`,
`pcdet.nms.round`, `pcdet.books`, `pcdet.forward`, `pcdet.backward`,
`pcdet.optimizer`): `record_function` ranges on the profiler's host clock,
which the device trace shares.  The harness's own ranges (`bench.*`) are
taken the same way.  For each span name, over the slice:

  n        - its count;
  host_s   - its host durations, summed;
  device_s - the device seconds of every kernel, copy and memset whose
             launching runtime call (the host event of the device event's
             correlation id, `events`) starts inside one of the span's host
             intervals, on any thread (autograd launches the backward's
             kernels from its device thread while the main thread sits in
             `pcdet.backward`), wherever the device event itself falls:
             a kernel that runs after its span has closed counts to it.
             A span's total holds the spans nested in it;
  idle_s   - the time inside the union of the span's host intervals with
             nothing on the device: outside the union of the device
             intervals, as `trace.summarize` takes them for `busy_s`.

`unlaunched_s` is the device time with no runtime call to match (none
where every launch was traced).  `reading(summary, batches, metric)` gives
a per-layer metric of `READINGS` a batch (or step) of the slice: None
where its span is absent, and for a device time where the slice has no
device event (the CPU).
"""
from torch.autograd import DeviceType

PREFIXES = ('pcdet.', 'bench.')

# per-layer metric -> (span, field, scale): the field a batch, times scale
READINGS = {
    'device_ms.voxelize.detect': ('pcdet.voxelize', 'device_s', 1e3),
    'device_ms.vfe.detect': ('pcdet.vfe', 'device_s', 1e3),
    'device_ms.rpn.detect': ('pcdet.rpn', 'device_s', 1e3),
    'device_ms.predict.detect': ('pcdet.predict', 'device_s', 1e3),
    'idle_ms.predict.detect': ('pcdet.predict', 'idle_s', 1e3),
    'nms_rounds.detect': ('pcdet.nms.round', 'n', 1),
    'device_ms.forward.train': ('pcdet.forward', 'device_s', 1e3),
    'device_ms.backward.train': ('pcdet.backward', 'device_s', 1e3),
    'device_ms.optimizer.train': ('pcdet.optimizer', 'device_s', 1e3),
    'idle_ms.optimizer.train': ('pcdet.optimizer', 'idle_s', 1e3),
}


def events(prof):
    """The profile's raw (Kineto) events as (name, on the device, start,
    end, correlation id, linked correlation id), times in microseconds
    from the trace's start as `prof.events()` gives them.  A runtime call
    has a linked id (the op it runs under) and the correlation id of the
    device event it launched; `prof.events()` keeps no linked id in some
    torch versions, so the raw events are read."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    for e in res.events():
        if getattr(e, 'is_hidden_event', lambda: False)():
            continue
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               (e.start_ns() - t0) * 1e-3, (e.end_ns() - t0) * 1e-3,
               e.correlation_id(), e.linked_correlation_id())


def intervals(evs):
    """(spans, launches) of `events`' tuples, times in microseconds:
    spans {name: [(start, end)]}, the host ranges named with PREFIXES;
    launches [(launch start or None, device start, device end)] of every
    kernel, copy and memset."""
    evs = list(evs)
    host = [e for e in evs if not e[1]]
    # a record_function range shows on the device timeline too, under its
    # host name: no kernel has the name of a host event
    host_names = {e[0] for e in host}
    spans, runtime = {}, {}
    for name, _, start, end, corr, linked in host:
        if name.startswith(PREFIXES):
            spans.setdefault(name, []).append((start, end))
        elif linked > 0:
            # a runtime call: its id is the device event's correlation id
            runtime[corr] = start
    launches = [(runtime.get(corr), start, end)
                for name, dev, start, end, corr, _ in evs
                if dev and name not in host_names]
    return spans, launches


def merge(iv):
    """Sorted disjoint intervals covering `iv`."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _inside(merged, t):
    """Whether t lies in one of the sorted disjoint intervals."""
    lo, hi = 0, len(merged)
    while lo < hi:
        mid = (lo + hi) // 2
        if merged[mid][1] < t:
            lo = mid + 1
        else:
            hi = mid
    return lo < len(merged) and merged[lo][0] <= t


def attribute(spans, launches):
    """({name: {n, host_s, device_s, idle_s}}, unlaunched_s) from the
    intervals of `intervals` (microseconds in, seconds out)."""
    busy = merge([(s, e) for _, s, e in launches])
    out = {}
    for name, iv in spans.items():
        union = merge(iv)
        dev = sum(e - s for t, s, e in launches
                  if t is not None and _inside(union, t))
        length = sum(e - s for s, e in union)
        out[name] = {'n': len(iv),
                     'host_s': sum(e - s for s, e in iv) * 1e-6,
                     'device_s': dev * 1e-6,
                     'idle_s': (length - overlap(union, busy)) * 1e-6}
    unlaunched = sum(e - s for t, s, e in launches if t is None) * 1e-6
    return out, unlaunched


def summarize(prof):
    """The slice's spans: {'spans': attribute's dict, 'unlaunched_s',
    'device_events'}."""
    spans, launches = intervals(events(prof))
    out, unlaunched = attribute(spans, launches)
    return {'spans': out, 'unlaunched_s': unlaunched,
            'device_events': len(launches)}


def reading(summary, batches, metric):
    """A `READINGS` metric a batch of the slice (`summary`: `summarize`'s
    dict), or None."""
    name, field, scale = READINGS[metric]
    span = summary['spans'].get(name)
    if span is None or not batches or (
            field != 'n' and not summary['device_events']):
        return None
    return scale * span[field] / batches
