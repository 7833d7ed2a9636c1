"""The traced slice's arithmetic and its completeness check, on synthetic
event lists."""

import pytest

from benchmark.cells import Reading, experiment
from benchmark.spec import Spec
from benchmark.tests.tiny import REPO
from benchmark.trace import Trace, busy_time


def _trace(sites: int, steps: int, drop: int = 0, us: float = 100.0):
    dev, t = [], 0.0
    for s in range(steps):
        for i in range(sites):
            for name in ("split_weights_kernel", "conv_stats_kernel",
                         "reduce_partials_kernel"):
                dev.append((f"void {name}(float const*)", t, t + us * 1e-6))
                t += us * 1e-6
            dev.append(("elementwise", t, t + 5e-6))
            t += 10e-6
    if drop:
        conv = [i for i, e in enumerate(dev) if "conv_stats" in e[0]]
        for i in reversed(conv[:drop]):
            del dev[i]
    host = [("cudaGraphLaunch", 0.0, 1e-5)] * steps
    return Trace(dev, host, (0.0, t + 1e-3))


def _reading(tr, units, cell="ct2mri.source"):
    """A reading of ``units`` of ``cell``'s work (batch 8 of 256 x 256)."""
    spec = Spec(REPO)
    w = spec.cell(cell)
    conf, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    return Reading(traffic["kind"], tr, units, conf, experiment(conf, 0),
                   traffic)


def test_complete_trace_gives_a_share_under_100():
    spec = Spec(REPO)
    tr = _trace(15, 4)
    share = spec.reader("conv_stats_roofline").read(_reading(tr, 4))
    # 1.771 ms of work (valid taps) in 15 * 300 us per step
    assert share == pytest.approx(100 * 1.77082879 / 4.5, rel=1e-6)


def test_a_trace_that_dropped_one_replayed_kernel_fails():
    spec = Spec(REPO)
    tr = _trace(15, 4, drop=1)
    with pytest.raises(RuntimeError, match="conv_stats_kernel"):
        spec.reader("conv_stats_roofline").read(_reading(tr, 4))


def test_a_cell_without_the_op_reads_nothing():
    spec = Spec(REPO)
    tr = Trace([("elementwise", 0.0, 1.0)], [], (0.0, 2.0))
    for cell in ("ct2mri.source", "ct2mri.serve"):
        r = _reading(tr, 1, cell)
        assert spec.reader("conv_stats_roofline").read(r) is None
        assert spec.reader("conv_bn_act_roofline").read(r) is None


def test_busy_idle_and_launches():
    tr = Trace([("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 3.0, 3.5)],
               [("cudaGraphLaunch", 0.0, 0.1), ("aten::add", 1.5, 3.0),
                ("cuLaunchKernel", 2.0, 2.1)], (0.0, 4.0))
    assert busy_time([(0, 1), (0.5, 1.5), (3, 3.5)]) == 2.0
    assert tr.busy_s() == 2.0
    assert tr.launches() == 2
    gaps = dict(tr.idle_gaps())
    assert gaps["host: aten::add"] == pytest.approx(1.5)
    assert sum(gaps.values()) == pytest.approx(2.0)
    r = _reading(tr, 2)
    spec = Spec(REPO)
    assert spec.reader("idle_share.train").read(r) == pytest.approx(50.0)
    assert spec.reader("idle_share.serve").read(r) is None
    assert spec.reader("launches_per_step").read(r) == 1.0
    assert spec.reader("device_ms_per_step").read(r) == 1000.0


def test_a_warm_up_forward_more_counts_as_work():
    spec = Spec(REPO)
    tr = _trace(15, 5)
    share = spec.reader("conv_stats_roofline").read(_reading(tr, 4))
    assert share == pytest.approx(100 * 1.77082879 / 4.5, rel=1e-6)
