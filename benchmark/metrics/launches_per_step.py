"""Host launch calls per train step: the CUDA runtime's and driver's
``*Launch*`` calls in the traced slice (a kernel each, or a whole graph),
over the train steps traced.  Layer: the loop, the drivers and the CUDA
graph that replace a step's thousands of launches by one per call."""

UNIT = "launches/step"
LAYER = "loop, drivers and CUDA graph"
MOVES = "train_slices_per_s"


def read(r):
    if r.kind != "train":
        return None
    return r.trace.launches() / r.units
