"""Host time per served volume in getting its uint8 mask to the host: the
program's ``predict.readback`` (the labels' copy off the card, after the
volume's work is done) and ``predict.cast`` (to uint8) spans inside its
``predict.volume`` spans, over the volumes traced.  Layer: the volume
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
    return 1000 * spans.seconds_inside(
        r, {"predict.readback", "predict.cast"}, vols) / r.units
