"""The whole train step's share of the card's dense TF32 peak: the
benchmark's FLOP count of a step (``flops.source_step`` or
``flops.adapt_step`` at the cell's batch, slice size and plug depth;
valid taps, 2 per multiply-add) times the steps traced, over the traced
slice's host time.  TF32 is the tensor-core rate of this float32 step."""

from benchmark import flops

UNIT = "%"
LAYER = "train step"
MOVES = "train_slices_per_s"


def read(r):
    if r.kind != "train":
        return None
    per_step = (flops.adapt_step(r.batch, r.size, r.cfg.adapt.plug_depth)
                if r.traffic["step"] == "adapt"
                else flops.source_step(r.batch, r.size))
    return 100 * per_step * r.units / r.trace.window_s \
        / r.peaks["tf32_flops"]
