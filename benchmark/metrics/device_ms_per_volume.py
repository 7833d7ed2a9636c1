"""Device busy time per served volume: the union of the device's kernel
and copy intervals in the traced slice, over the volumes traced.  Layer:
the volume loop (upload, context gather, the fused eval forward per
batch, argmax, readback)."""

UNIT = "ms"
LAYER = "volume loop"
MOVES = "serve_slices_per_s"


def read(r):
    if r.kind != "serve":
        return None
    return 1000 * r.trace.busy_s() / r.units
