"""On the card, at each cell's own size: the program's check numbers stay
inside their limits and the lower-precision control's do not, on three
seeds; and a train run whose CUDA graph replays alone are broken comes
out not correct.  Run there with ``python -m pytest benchmark/tests -m
cuda`` from the repository's root; skipped without a CUDA device."""

from __future__ import annotations

import pytest
import torch

from benchmark import cells, judge, run
from benchmark.reference import pnp_adanet as ref
from benchmark.spec import Spec
from benchmark.tests.tiny import REPO

CELLS = ["ct2mri.source", "mri2ct.adapt", "ct2mri.serve", "mri2ct.serve"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails_at_the_cells_size(card, cell):
    spec = Spec(REPO)
    w = spec.cell(cell)
    limits = spec.limits(cell)
    for seed in (3600000001, 3600000002, 3600000003):
        c = cells.make(spec.config(w["config"]), spec.traffic(w["traffic"]),
                       seed, card)
        c.setup()
        if c.kind == "serve":
            c.window(3.0)
        c.release()
        if c.kind == "train":
            side = c.reference()
            program = c.readings(side)
            control = c.readings(side, c.reference(ref.tf32_round))
        else:
            probs = c.reference_probs()
            program = c.serve_readings(probs, c.served)[0]
            control = c.serve_readings(probs,
                                       c.control_masks(ref.fp8_round))[0]
        assert judge.verdict(program, limits)[0], program
        assert not judge.verdict(control, limits)[0], control
        del c
        cells._free(card)


class _NoReseed:
    """A graph's generator whose re-seed before a replay does nothing, so
    each replay draws on from where the last one stopped."""

    def __init__(self, gen):
        self.gen = gen

    def manual_seed(self, seed):
        return self.gen


def _no_reseed(monkeypatch):
    from mcmda_tpu_torch.utils import cuda_graph
    capture = cuda_graph.GraphedSteps._capture

    def broken(self, *a, **kw):
        capture(self, *a, **kw)
        self.gen = _NoReseed(self.gen)
    monkeypatch.setattr(cuda_graph.GraphedSteps, "_capture", broken)


def _one_seed(monkeypatch):
    """Every replay of a call seeded as its first."""
    from mcmda_tpu_torch.utils import prng
    inner_key = prng.inner_key
    monkeypatch.setattr(prng, "inner_key",
                        lambda seed, i, inner: inner_key(seed, 0, inner))


def _no_replay(monkeypatch):
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", lambda self: None)


REPLAY_FAULTS = {"no_reseed": _no_reseed, "one_seed": _one_seed,
                 "no_replay": _no_replay}


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [
    ("ct2mri.source", "no_replay"), ("ct2mri.source", "no_reseed"),
    ("ct2mri.source", "one_seed"), ("mri2ct.adapt", "no_replay"),
    ("mri2ct.adapt", "no_reseed")])
def test_a_fault_in_the_replays_alone_is_not_correct(card, cell, fault,
                                                     monkeypatch):
    """The eager first step and the capture are left sound; only what the
    window's replays do is broken, and the run is not correct.  A call's
    replays seeded as its first are T1's ``loss_gap`` to catch: T2's
    later losses spread too far for a limit (see ``judge``), and both
    cells replay through the one ``GraphedSteps``."""
    REPLAY_FAULTS[fault](monkeypatch)
    out = run.run_cell(Spec(REPO), cell, 3600000011, 2.0, False,
                       device=card)
    assert not out["correct"], out["checks"]
    cells._free(card)
