"""Host time per served volume in the copy of its voxels into the serving
graph's buffer: the program's ``graph.load`` spans inside its
``predict.volume`` spans, over the volumes traced (the pageable host
copy and its staging, as the host waits for them).  Layer: the volume
loop."""

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
    return 1000 * spans.seconds_inside(r, {"graph.load"}, vols) / r.units
