"""The conv + BN-moments op's share of its roofline: the least time of
its sites' work (``roofline.conv_stats_sites`` at the cell's batch and
slice size, one train forward's 15; one such forward a step) for every
forward the trace holds, over the traced device time of its kernels (the
conv, the partial-moment reduction and the weight pre-split).  The trace
has to hold a conv kernel for each site of each step traced, in whole
forwards, or the run fails."""

from benchmark import roofline
from benchmark.trace import check_count

UNIT = "%"
LAYER = "conv + BN-moments kernel"
MOVES = "train_slices_per_s"
KERNELS = ("conv_stats_kernel", "reduce_partials_kernel",
           "split_weights_kernel")


def read(r):
    if r.kind != "train" or r.trace.count(KERNELS[0]) == 0:
        return None
    sites = roofline.conv_stats_sites(r.batch, r.size)
    n = len(sites)
    got = check_count(r.trace, KERNELS[0], n * r.units, n)
    return 100 * roofline.bound_seconds(sites) * (got // n) \
        / r.trace.seconds(KERNELS)
