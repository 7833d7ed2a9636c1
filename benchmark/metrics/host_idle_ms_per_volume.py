"""Time per served volume in which the card waits on the program's own
host work: inside the program's ``predict.volume`` spans, the time when
no device interval (kernel or copy) is open, over the volumes traced.
The client's time between calls lies outside the spans.  Layer: the
volume loop."""

from benchmark import spans

UNIT = "ms"
LAYER = "volume loop"
MOVES = "serve_slices_per_s"


def read(r):
    if r.kind != "serve":
        return None
    vols = spans.volumes(r)
    if vols is None:
        return None
    return 1000 * spans.idle_inside(r, vols) / r.units
