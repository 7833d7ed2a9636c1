"""Profiling / tracing (counterpart of ``mcmda_tpu/utils/profiling.py``).

- ``span(name)``: a named host span around a step of the program, seen
  by ``torch.profiler`` on its own clock and free when no profiler runs.
- ``trace(logdir)``: a ``torch.profiler`` context that writes a Chrome
  trace (``chrome://tracing``, Perfetto) into ``logdir``.
- ``measure_step``: a few steps under the profiler -> host clock per step,
  the device's busy time and idle share, kernels per step and the kernels
  that take the most device time.

The JAX package's ``hbm_traffic_from_trace`` and
``aggregate_roofline_traffic`` parse XProf tables, which CUDA does not
have, and are not ported; ``measure_step`` stands where it has
``measure_step_hbm_traffic``.
"""

from __future__ import annotations

import collections.abc
import contextlib
import os
import time

import torch

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError as e:  # torch before 2.2
    raise ImportError(
        "mcmda_tpu_torch needs torch._C._profiler._RecordFunctionFast "
        f"(torch 2.2 or later) for its spans; this torch is "
        f"{torch.__version__}") from e


def span(name: str):
    """A context that records the block as a host event named ``name``
    while ``torch.profiler`` runs, and costs under a microsecond when none
    does.  The event is an operator event (``cpu_op`` in a Chrome trace),
    not a ``record_function`` annotation, so it casts no shadow on the
    device's timeline: a device trace's busy time stays that of its
    kernels and copies.  Names are ``<layer>.<step>``, never a kernel's
    symbol nor a ``cu*Launch*`` call's."""
    return _RecordFunctionFast(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host activity, and the GPU's when there is one)
    and write ``<logdir>/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def busy_time(spans) -> float:
    """Length of the union of ``(start, end)`` intervals: the time during
    which at least one of them is open.  Overlapping and nested intervals
    count once."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def measure_step(step, state, data, n: int = 3,
                 inner_steps: int = 1) -> dict:
    """Run ``n`` calls ``step(state, data, seed)`` on the GPU under
    ``torch.profiler``, each ``inner_steps`` train steps (a
    ``loop.scanned_step``), and return

      steps                  n * inner_steps
      host_ms_per_step       host clock around the calls and a final
                             synchronise, per step
      device_busy_ms_per_step  union of the device events' intervals (kernels
                             and copies), per step
      idle_share             1 - device busy time / host clock
      kernels_per_step       device events per step
      host_launches_per_step the host's launch calls per step (CUDA
                             runtime and driver calls named ``*Launch*``:
                             a kernel each, or a whole graph)
      top_kernels            [(name, device ms per step)], the 5 largest

    ``data`` is what every step gets; an iterator (a feed) gives each step
    its ``next``.  The input ``state`` survives the call (states are
    functional).  Raises if the trace holds no device event.  This stands
    where the JAX package has ``measure_step_hbm_traffic``, which reads HBM
    traffic from XProf's roofline tables; CUDA's profiler has no such
    table, so the port measures where the device's time goes instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    feed = isinstance(data, collections.abc.Iterator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            state, _ = step(state, next(data) if feed else data, 1000 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("measure_step: no device events in the trace")
    launches = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith("cu") and "Launch" in e.name)
    n_steps = n * inner_steps
    busy = busy_time((e.time_range.start, e.time_range.end)
                     for e in events) / 1000.0
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"steps": n_steps, "host_ms_per_step": wall / n_steps,
            "device_busy_ms_per_step": busy / n_steps,
            "idle_share": 1 - busy / wall,
            "kernels_per_step": len(events) / n_steps,
            "host_launches_per_step": launches / n_steps,
            "top_kernels": [(k, t / 1000.0 / n_steps) for k, t in top]}
