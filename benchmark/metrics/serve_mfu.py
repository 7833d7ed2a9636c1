"""The whole serving forward's share of the card's dense bf16 peak (the
configurations serve in bf16): the benchmark's FLOP count of a volume's
forwards (``flops.serve_forward`` at the serving forward's batch, depth /
batch forwards rounded up; valid taps, 2 per multiply-add) times the
volumes traced, over the traced slice's host time."""

from benchmark import flops

UNIT = "%"
LAYER = "volume loop"
MOVES = "serve_slices_per_s"


def read(r):
    if r.kind != "serve":
        return None
    forwards = -(-r.traffic["depth"] // r.batch)
    per_volume = forwards * flops.serve_forward(r.forward_batch, r.size,
                                                r.serve_dtype)
    return 100 * per_volume * r.units / r.trace.window_s \
        / r.peaks["bf16_flops"]
