"""The fused conv + BN + ReLU op's share of its roofline: the least time
of its sites' work (``roofline.conv_bn_act_sites`` at the serving
forward's batch, one forward's 19) for every forward the trace holds,
over the traced device time of its kernels (the conv and the weight
pre-split).  A volume of ``depth`` slices takes depth / batch forwards,
rounded up.  The trace has to hold a conv kernel for each site of each
forward that the traced volumes take, in whole forwards, or the run
fails; a forward more (the warm-up of a capture) is work the kernel did
and counts."""

from benchmark import roofline
from benchmark.trace import check_count

UNIT = "%"
LAYER = "fused conv + BN + ReLU kernel"
MOVES = "serve_slices_per_s"
KERNELS = ("conv_bn_act_kernel", "split_weights_kernel")


def read(r):
    if r.kind != "serve" or r.trace.count(KERNELS[0]) == 0:
        return None
    sites = roofline.conv_bn_act_sites(r.forward_batch, r.size,
                                       r.serve_dtype == "bfloat16")
    forwards = -(-r.traffic["depth"] // r.batch)
    n = len(sites)
    got = check_count(r.trace, KERNELS[0], n * forwards * r.units, n)
    return 100 * roofline.bound_seconds(sites) * (got // n) \
        / r.trace.seconds(KERNELS)
