"""Spans and the device trace of a traced run.

The program has no spans of its own yet, so the benchmark puts them around
its calls into each layer (:class:`Spans`): a host-clock interval with a
``synchronize()`` at both edges, taken in the traced run only, and a
``record_function`` range of the same name (``bench.<name>``) that the
profiler sees. :func:`profile` runs a callable under ``torch.profiler``
with CUDA activity and reduces the trace to a :class:`TraceSummary`: the
device's busy time (the union of its kernels, copies and sets), the kernel
times by name, the device work inside each span, and the longest idle gaps
by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from collections import defaultdict

SPAN_PREFIX = "bench."
TOP = 10            # entries of each breakdown list
NAME_CHARS = 160    # a device op's name is cut to this length
SCAN = 4000         # host events looked at for one gap's label


class Spans:
    """Host-clock spans by name, each a list of seconds; ``sync`` is the
    device synchronisation taken at both edges (a no-op on the CPU)."""

    def __init__(self, sync):
        self.sync = sync
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        self.sync()
        t0 = time.perf_counter()
        with record_function(SPAN_PREFIX + name):
            yield
        self.sync()
        self.times[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        """``fn`` with a span around each call."""
        def spanned(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        spanned.__wrapped__ = fn
        return spanned

    def mean_ms(self, name: str):
        times = self.times.get(name)
        return None if not times else sum(times) / len(times) * 1e3


@dataclasses.dataclass
class TraceSummary:
    window_s: float                 # host seconds of the traced window
    busy_s: float                   # device busy seconds, mean over devices
    devices: int
    kernels: dict                   # name -> [count, seconds], all devices
    device_events: int
    span_calls: dict                # span name -> ranges traced
    span_device_events: dict        # span name -> device events inside
    gaps: list                      # [[label, seconds]], longest first

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name contains one of
        ``names``."""
        return sum(s for k, (_, s) in self.kernels.items()
                   if any(n in k for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
        return {"device_ops": [[k[:NAME_CHARS], s] for k, (_, s) in ops],
                "idle_gaps": self.gaps[:TOP]}


def _is_device(e, cuda_type) -> bool:
    return (e.device_type == cuda_type
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(SPAN_PREFIX))


def summarize(events, window_s: float) -> TraceSummary:
    """Reduce the profiler's events (``prof.events()``) of a window of
    ``window_s`` host seconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if _is_device(e, cuda)]
    host = [e for e in events if e.device_type != cuda]
    kernels = defaultdict(lambda: [0, 0.0])
    by_device = defaultdict(list)
    for e in dev:
        k = kernels[e.name]
        k[0] += 1
        k[1] += e.time_range.elapsed_us() / 1e6
        by_device[e.device_index].append((e.time_range.start,
                                          e.time_range.end))
    busy = {d: _union(iv) for d, iv in by_device.items()}
    n_dev = max(1, len(busy))
    busy_s = sum(b for b, _ in busy.values()) / 1e6 / n_dev

    spans = defaultdict(list)
    for e in host:
        if e.name.startswith(SPAN_PREFIX):
            spans[e.name[len(SPAN_PREFIX):]].append(
                (e.time_range.start, e.time_range.end))
    starts = sorted(e.time_range.start for e in dev)
    inside = {}
    for name, ranges in spans.items():
        inside[name] = sum(bisect.bisect_right(starts, b)
                           - bisect.bisect_left(starts, a) for a, b in ranges)

    gaps = defaultdict(float)
    label = _labeller(host)
    for merged in (m for _, m in busy.values()):
        for (_, end), (start, _) in zip(merged, merged[1:]):
            gaps[label((end + start) / 2)] += (start - end) / 1e6
    return TraceSummary(
        window_s=window_s, busy_s=busy_s, devices=n_dev,
        kernels=dict(kernels), device_events=len(dev),
        span_calls={k: len(v) for k, v in spans.items()},
        span_device_events=inside,
        gaps=[[k, s] for k, s in sorted(gaps.items(), key=lambda kv: -kv[1])])


def _union(intervals):
    """(covered microseconds, merged intervals) of ``intervals``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _labeller(host):
    """A function from a time to what the host was doing then: the
    benchmark's span around it and the innermost host op that covers it."""
    ev = sorted(((e.time_range.start, e.time_range.end, e.name)
                 for e in host), key=lambda x: x[0])
    starts = [x[0] for x in ev]
    span_ev = [x for x in ev if x[2].startswith(SPAN_PREFIX)]
    span_starts = [x[0] for x in span_ev]

    def innermost(seq, seq_starts, t):
        i = bisect.bisect_right(seq_starts, t) - 1
        for j in range(i, max(-1, i - SCAN), -1):
            if seq[j][1] >= t:
                return seq[j][2]
        return None

    def label(t):
        span = innermost(span_ev, span_starts, t)
        op = innermost(ev, starts, t)
        span = span[len(SPAN_PREFIX):] if span else "outside spans"
        if op is None or op.startswith(SPAN_PREFIX):
            return span
        return f"{span}: {op[:NAME_CHARS]}"

    return label


def profile(fn, sync, cuda: bool = True) -> TraceSummary:
    """Run ``fn()`` under ``torch.profiler`` with CPU and (``cuda``) CUDA
    activity, ``sync`` before and after, and summarise its trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    sync()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    return summarize(prof.events(), window)
