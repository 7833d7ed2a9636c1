"""One traced slice of a run, and what the per-layer readers take from it.

``record`` runs a function under ``torch.profiler`` (host and CUDA
activity); the function opens a host marker span (``marker``) around the
slice to read, and the readers take what lies inside it from the raw
events: the
kernels and copies on the device (graph replays included, which is where
the kernels of a CUDA-graph step are) and the host's operator and runtime
events.  Nothing is written to disk.  The events are read straight from
the profiler's result list, not through its Python event tree, which
would take longer than the window for some hundred thousand kernels.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

MARK = "benchmark.traced_slice"
SMALL_GAP_S = 20e-6  # a gap this short is a stream's own launch latency


@dataclasses.dataclass
class Trace:
    device: list      # (name, start_s, end_s), sorted by start
    host: list        # (name, start_s, end_s), the marker left out
    window: tuple     # (start_s, end_s) of the marker span

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Length of the union of the device intervals inside the window."""
        lo, hi = self.window
        return busy_time((max(a, lo), min(b, hi)) for _, a, b in self.device
                         if b > lo and a < hi)

    def _inside(self):
        lo, hi = self.window
        return [e for e in self.device if lo <= e[1] < hi]

    def count(self, symbol: str) -> int:
        """Device events inside the window whose name holds ``symbol``."""
        return sum(1 for n, _, _ in self._inside() if symbol in n)

    def seconds(self, symbols) -> float:
        return sum(b - a for n, a, b in self._inside()
                   if any(s in n for s in symbols))

    def launches(self) -> int:
        """The host's kernel and graph launch calls inside the window (CUDA
        runtime and driver calls named ``cu*Launch*``)."""
        lo, hi = self.window
        return sum(1 for n, a, _ in self.host
                   if lo <= a < hi and n.startswith("cu") and "Launch" in n)

    def device_ops(self, top: int = 10):
        by: dict = {}
        for n, a, b in self._inside():
            by[n] = by.get(n, 0.0) + (b - a)
        return sorted(([_short(n), s] for n, s in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """Idle time inside the window by what the host was doing: the
        gaps between device intervals, each named by the innermost host
        event open at its middle; gaps under ``SMALL_GAP_S`` are one
        group of their own."""
        lo, hi = self.window
        spans = sorted((max(a, lo), min(b, hi)) for _, a, b in self.device
                       if b > lo and a < hi)
        gaps, end = [], lo
        for a, b in spans:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        by: dict = {}
        for a, b in gaps:
            if b - a < SMALL_GAP_S:
                name = f"gaps under {SMALL_GAP_S * 1e6:.0f} us"
            else:
                mid = 0.5 * (a + b)
                i = bisect.bisect_right(starts, mid)
                open_ = [e for e in host[:i] if e[2] >= mid]
                name = ("host: " + _short(min(open_, key=lambda e:
                                              e[2] - e[1])[0])
                        if open_ else "host: no traced event")
            by[name] = by.get(name, 0.0) + (b - a)
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda kv: -kv[1])[:top]


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def busy_time(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def _times(e):
    if hasattr(e, "start_ns"):
        a = e.start_ns()
        return a * 1e-9, (a + e.duration_ns()) * 1e-9
    a = e.start_us()
    return a * 1e-6, (a + e.duration_us()) * 1e-6


def marker():
    """The span that bounds the traced slice: open it around the work to
    read (after a synchronise) and close it once the device is done."""
    from torch.profiler import record_function
    return record_function(MARK)


def record(fn) -> Trace:
    """Run ``fn()`` under the profiler; ``fn`` opens ``marker()`` around
    the slice to read, which may be part of what it runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        a, b = _times(e)
        name = e.name()
        if name == MARK:  # the marker's host span and its device shadow
            if e.device_type() != DeviceType.CUDA:
                window = (a, b)
        elif e.device_type() == DeviceType.CUDA:
            device.append((name, a, b))
        else:
            host.append((name, a, b))
    if window is None:
        raise RuntimeError("the trace lost its marker span")
    if not device:
        raise RuntimeError("the trace holds no device event")
    device.sort(key=lambda e: e[1])
    return Trace(device, host, window)


def check_count(trace, symbol: str, needed: int, per: int) -> int:
    """Raise unless the trace holds at least the ``needed`` kernels named
    ``symbol`` that the traced work takes, in whole forwards of ``per``:
    a trace that dropped replayed kernels would read a share too high.
    More whole forwards than the work needs are work the program does
    (such as a warm-up forward before a capture) and count."""
    got = trace.count(symbol)
    if got < needed or got % per:
        raise RuntimeError(f"the trace holds {got} {symbol} kernels where "
                           f"the traced work takes {needed}, in whole "
                           f"forwards of {per}")
    return got
