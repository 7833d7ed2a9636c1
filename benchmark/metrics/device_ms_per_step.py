"""Device busy time per train step: the union of the device's kernel and
copy intervals in the traced slice, over the train steps traced.  Layer:
the train step (sampling, warp, forward, losses, backward, Adam)."""

UNIT = "ms"
LAYER = "train step"
MOVES = "train_slices_per_s"


def read(r):
    if r.kind != "train":
        return None
    return 1000 * r.trace.busy_s() / r.units
