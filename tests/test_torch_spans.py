"""The port's host spans (``profiling.span``): what a profiler sees of the
volume loop, the CUDA graphs and the train loop, and that nothing is
recorded without one.

This file imports neither jax nor the JAX package.  The tests marked
``cuda`` need a GPU and skip without one; on a GPU machine without jax::

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import importlib.util
import itertools
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mcmda_tpu_torch import api
from mcmda_tpu_torch.config import DataConfig, ExperimentConfig, \
    SegmenterConfig, StageSpec
from mcmda_tpu_torch.train import loop, source
from mcmda_tpu_torch.utils import cuda_graph, device as device_mod, profiling

PACKAGE = Path(profiling.__file__).resolve().parents[1]
REPO = PACKAGE.parent
SPANS = {"predict.volume", "predict.wait", "predict.readback",
         "predict.cast", "predict.postprocess", "graph.load",
         "graph.replay", "graph.capture", "train.call", "train.log",
         "train.probe", "train.checkpoint"}


def _events(fn, cuda=False):
    """[(name, device type, start_ns, end_ns)] of ``fn()`` profiled."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        fn()
    return [(e.name(), e.device_type(), e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _spans(events, name):
    return sorted((a, b) for n, t, a, b in events
                  if n == name and t == DeviceType.CPU)


def _inside(spans, outer):
    """How many of ``spans`` each of the ``outer`` spans holds."""
    return [sum(1 for a, b in spans if oa <= a and b <= ob)
            for oa, ob in outer]


def _cfg():
    """A small config: 32 x 32 slices, thin stages, the same topology."""
    stages = (StageSpec("stem", 8, 1, 1, 1), StageSpec("rm1", 8, 2, 1, 1),
              StageSpec("rm2", 16, 2, 1, 1), StageSpec("rm3", 16, 2, 1, 1),
              StageSpec("rm4", 24, 1, 2, 1), StageSpec("rm5", 24, 1, 2, 1))
    return ExperimentConfig(segmenter=SegmenterConfig(stages=stages),
                            data=DataConfig(slice_size=32, batch_size=4))


# ------------------------------------------------------------------ helper
def test_a_span_is_an_operator_event_and_casts_no_shadow(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("predict.volume"):
            torch.ones(8) + 1
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    cats = [e.get("cat") for e in events if e.get("name") == "predict.volume"]
    assert cats == ["cpu_op"]


def test_a_span_holds_what_runs_inside_it():
    def work():
        with profiling.span("graph.load"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    ev = _events(work)
    (outer,) = _spans(ev, "graph.load")
    assert _inside(_spans(ev, "aten::mm"), [outer]) == [1]


def test_a_span_without_a_profiler_records_nothing():
    assert not torch.autograd._profiler_enabled()
    with profiling.span("train.call"):
        pass

    def after():
        torch.ones(2) + 1
    assert not [e for e in _events(after) if e[0] == "train.call"]


def test_a_torch_without_the_fast_span_is_refused_at_import(monkeypatch):
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    spec = importlib.util.spec_from_file_location(
        "profiling_copy", Path(profiling.__file__))
    with pytest.raises(ImportError, match="_RecordFunctionFast"):
        spec.loader.exec_module(importlib.util.module_from_spec(spec))


def test_the_program_opens_only_known_spans_that_no_reader_mistakes():
    """Every span name in the package is one of ``SPANS``, each is named
    in PERF.md with its reader, and none holds a kernel's symbol or reads
    as a ``cu*Launch*`` call (what the benchmark's readers match)."""
    found = set()
    for path in PACKAGE.rglob("*.py"):
        found |= set(re.findall(r'profiling\.span\("([^"]+)"\)',
                                path.read_text()))
    assert found == SPANS
    perf = (REPO / "PERF.md").read_text()
    for name in SPANS:
        assert f"`{name}`" in perf, name
        assert not (name.startswith("cu") and "Launch" in name)
        assert "kernel" not in name and "Memcpy" not in name


# ------------------------------------------------------------- volume loop
@pytest.mark.parametrize("postprocess", ["none", "cc"])
def test_predict_opens_one_volume_span_per_volume(postprocess):
    cfg = _cfg()
    state = source.init_state(0, cfg, "cpu")
    rng = np.random.default_rng(0)
    vols = [rng.normal(size=(5, 32, 32)).astype(np.float32)
            for _ in range(3)]
    out = []
    ev = _events(lambda: out.extend(api.predict(cfg, state, vols,
                                                postprocess=postprocess)))
    assert len(out) == 3 and all(m.dtype == np.uint8 for m in out)
    vol = _spans(ev, "predict.volume")
    assert len(vol) == 3
    assert _inside(_spans(ev, "predict.readback"), vol) == [1, 1, 1]
    assert _inside(_spans(ev, "predict.cast"), vol) == [1, 1, 1]
    want = [1, 1, 1] if postprocess == "cc" else [0, 0, 0]
    assert _inside(_spans(ev, "predict.postprocess"), vol) == want
    assert not _spans(ev, "predict.wait")   # the CPU waits for nothing


# -------------------------------------------------------------- train loop
@pytest.mark.parametrize("inner,calls,logs,probes,saves", [
    (1, 8, 5, 2, 2),   # log ticks 0, 2, 4, 6, 7; probes at 4, 8
    (2, 4, 4, 2, 2),   # a call ends at steps 1, 3, 5, 7, each a log tick
])
def test_loop_opens_its_spans_at_its_ticks(tmp_path, inner, calls, logs,
                                           probes, saves):
    def step(state, batch, seed):
        return {"w": state["w"] + 1}, {"loss": state["w"].sum()}

    ticks = []
    fn = loop.scanned_step(step, inner)
    ev = _events(lambda: loop.run(
        fn, {"w": torch.zeros(2)}, itertools.repeat(None), 8, log_every=2,
        ckpt_every=4, ckpt_dir=str(tmp_path), inner_steps=inner,
        probe_every=4, probe=lambda s, st, m: ticks.append(s)))
    assert ticks == [4, 8]
    assert len(_spans(ev, "train.call")) == calls
    assert len(_spans(ev, "train.log")) == logs
    assert len(_spans(ev, "train.probe")) == probes
    assert len(_spans(ev, "train.checkpoint")) == saves
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004.npz", "step_00000008.npz"]


# -------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CPU runs no graph")
    return device_mod.resolve("cuda")


@pytest.mark.cuda
def test_graphed_call_spans(cuda_device):
    g = cuda_graph.GraphedCall(lambda x: x * 2, lambda x: x * 2,
                               cuda_device)
    xs = [torch.full((4,), float(i)) for i in range(3)]
    out = []
    ev = _events(lambda: out.extend(g(x) for x in xs), cuda=True)
    assert [float(o[0]) for o in out] == [0.0, 2.0, 4.0]
    assert len(_spans(ev, "graph.capture")) == 1
    assert len(_spans(ev, "graph.load")) == 2     # the calls after it
    assert len(_spans(ev, "graph.replay")) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("fed,inner", [(False, 3), (True, 1)])
def test_graphed_steps_spans(cuda_device, fed, inner):
    def step(state, batch, seed):
        return ({"w": state["w"] + batch["x"].sum()},
                {"loss": state["w"].sum()})

    g = cuda_graph.GraphedSteps(step, inner, fed=fed)
    batch = {"x": torch.ones(4, device=cuda_device)}

    def calls():
        state = {"w": torch.zeros(2, device=cuda_device)}
        for seed in range(3):
            state, _ = g(state, {"x": batch["x"].clone()} if fed else batch,
                         seed)
        torch.cuda.synchronize()
        assert float(state["w"][0]) == 4.0 * 3 * inner
    ev = _events(calls, cuda=True)
    assert len(_spans(ev, "graph.capture")) == 1
    assert len(_spans(ev, "graph.load")) == 2
    assert len(_spans(ev, "graph.replay")) == (3 if inner > 1 else 2)


@pytest.mark.cuda
def test_no_device_event_carries_a_span_name(cuda_device):
    """A traced serving slice: the spans are host events alone (no
    ``gpu_user_annotation`` shadow), the first volume holds the capture,
    the later ones a load and a wait."""
    cfg = _cfg()
    state = source.init_state(0, cfg, cuda_device)
    rng = np.random.default_rng(0)
    vols = [rng.normal(size=(6, 32, 32)).astype(np.float32)
            for _ in range(3)]
    ev = _events(lambda: api.predict(cfg, state, vols), cuda=True)
    assert not [e for e in ev if e[1] == DeviceType.CUDA and e[0] in SPANS]
    assert any(e[1] == DeviceType.CUDA for e in ev)
    vol = _spans(ev, "predict.volume")
    assert len(vol) == 3
    assert _inside(_spans(ev, "graph.capture"), vol) == [1, 0, 0]
    assert _inside(_spans(ev, "graph.load"), vol) == [0, 1, 1]
    for name in ("graph.replay", "predict.wait", "predict.readback",
                 "predict.cast"):
        assert _inside(_spans(ev, name), vol) == [1, 1, 1], name
