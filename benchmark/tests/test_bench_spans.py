"""The readers of the program's own spans, on a hand-built traced slice."""

import pytest

from benchmark.cells import Reading, experiment
from benchmark.spec import Spec
from benchmark.tests.tiny import REPO
from benchmark.trace import Trace

READERS = ("upload_ms_per_volume", "readback_ms_per_volume",
           "host_idle_ms_per_volume")


def _trace(spans=True):
    """Two volumes in a window of (0, 10) s, and a first one (the call's
    capture) before it; the device busy over part of each volume."""
    host = [("aten::copy_", 1.15, 1.25), ("cudaGraphLaunch", 1.35, 1.36)]
    if spans:
        host += [
            ("predict.volume", -2.0, -0.5), ("graph.load", -1.9, -1.0),
            ("predict.volume", 1.0, 3.0), ("graph.load", 1.1, 1.3),
            ("graph.replay", 1.3, 1.4), ("predict.wait", 1.4, 2.5),
            ("predict.readback", 2.5, 2.7), ("predict.cast", 2.7, 2.9),
            ("predict.volume", 4.0, 7.0), ("graph.load", 4.2, 4.6),
            ("predict.readback", 6.0, 6.4), ("predict.cast", 6.4, 6.9),
            ("graph.load", 8.0, 9.0)]   # outside any volume: not counted
    device = [("Memcpy HtoD", 1.2, 1.3), ("conv_bn_act_kernel", 1.3, 2.5),
              ("Memcpy DtoH", 2.5, 2.6), ("Memcpy HtoD", 4.3, 4.5),
              ("conv_bn_act_kernel", 4.4, 6.3), ("Memcpy HtoD", 8.1, 8.9)]
    return Trace(device, host, (0.0, 10.0))


def _reading(tr, units, cell="ct2mri.serve"):
    spec = Spec(REPO)
    w = spec.cell(cell)
    conf, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    return Reading(traffic["kind"], tr, units, conf, experiment(conf, 0),
                   traffic)


@pytest.mark.parametrize("metric,want", [
    ("upload_ms_per_volume", 1000 * (0.2 + 0.4) / 2),
    ("readback_ms_per_volume", 1000 * (0.2 + 0.2 + 0.4 + 0.5) / 2),
    # vol 1: 2.0 s less the device's 1.2-2.6; vol 2: 3.0 less 4.3-6.3
    ("host_idle_ms_per_volume", 1000 * (0.6 + 1.0) / 2),
])
def test_each_reader_on_a_hand_built_slice(metric, want):
    r = _reading(_trace(), 2)
    assert Spec(REPO).reader(metric).read(r) == pytest.approx(want)


@pytest.mark.parametrize("metric", READERS)
def test_a_train_cell_reads_nothing(metric):
    r = _reading(_trace(), 2, cell="ct2mri.source")
    assert Spec(REPO).reader(metric).read(r) is None


@pytest.mark.parametrize("metric", READERS)
def test_a_program_without_spans_reads_nothing(metric):
    assert Spec(REPO).reader(metric).read(_reading(_trace(False), 2)) is None


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("units", [1, 3])
def test_a_trace_with_another_count_of_volume_spans_fails(metric, units):
    with pytest.raises(RuntimeError, match="predict.volume"):
        Spec(REPO).reader(metric).read(_reading(_trace(), units))


def test_the_readers_are_entries_of_the_serve_cells():
    spec = Spec(REPO)
    for cell in ("ct2mri.serve", "mri2ct.serve"):
        names = [m["name"] for m in spec.per_layer(cell)]
        assert set(READERS) <= set(names)
    for cell in ("ct2mri.source", "mri2ct.adapt"):
        assert not set(READERS) & {m["name"] for m in spec.per_layer(cell)}
    for name in READERS:
        mod = spec.reader(name)
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
            "ms", "volume loop", "serve_slices_per_s")
