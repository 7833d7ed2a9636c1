"""The device's idle share in the traced serving slice: 1 - busy time /
host time."""

UNIT = "%"
LAYER = "device"
MOVES = "serve_slices_per_s"


def read(r):
    if r.kind != "serve":
        return None
    return 100 * (1 - r.trace.busy_s() / r.trace.window_s)
