"""The device's idle share in the traced train slice: 1 - busy time /
host time."""

UNIT = "%"
LAYER = "device"
MOVES = "train_slices_per_s"


def read(r):
    if r.kind != "train":
        return None
    return 100 * (1 - r.trace.busy_s() / r.trace.window_s)
