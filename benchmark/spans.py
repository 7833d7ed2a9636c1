"""The program's own host spans in a traced slice.

The port opens named host spans (``mcmda_tpu_torch.utils.profiling.span``)
around the steps of its volume loop, its CUDA graphs and its train loop;
they reach ``Trace.host`` on the profiler's clock.  A serving reader
takes the ``predict.volume`` spans that start inside the window, one per
volume served, and what lies inside them: a child span belongs to the
volume span that holds it in time (the loop runs on one thread).  A
program that opens no span yields nothing to read.
"""

from __future__ import annotations

import bisect

from benchmark.trace import busy_time

VOLUME = "predict.volume"


def volumes(r):
    """The (start, end) of each ``predict.volume`` span that starts inside
    the window, in order; None where there is none (a program without
    spans).  Raises unless there is one per volume traced
    (``r.units``): a trace that lost spans would read low."""
    lo, hi = r.trace.window
    vols = sorted((a, b) for n, a, b in r.trace.host
                  if n == VOLUME and lo <= a < hi)
    if not vols:
        return None
    if len(vols) != r.units:
        raise RuntimeError(f"the trace holds {len(vols)} {VOLUME} spans "
                           f"where {r.units} volumes were traced")
    return vols


def seconds_inside(r, names, vols) -> float:
    """Summed length of the host spans named in ``names`` that lie inside
    one of the volume spans ``vols``."""
    starts = [a for a, _ in vols]
    total = 0.0
    for n, a, b in r.trace.host:
        if n in names:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and b <= vols[i][1]:
                total += b - a
    return total


def idle_inside(r, vols) -> float:
    """Time inside the volume spans ``vols`` when no device interval is
    open."""
    idle = 0.0
    for va, vb in vols:
        idle += (vb - va) - busy_time(
            (max(a, va), min(b, vb)) for _, a, b in r.trace.device
            if b > va and a < vb)
    return idle
