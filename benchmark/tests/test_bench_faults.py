"""The check fails what it has to fail, at a size the CPU holds.

Each test drives a whole run of a cell through ``run.run_cell`` on the CPU
(the harness's look for a card skipped), with the cell's own limits, and
the timed path broken underneath: a step that returns its state
unchanged, half of each batch left out (the mean taken over the rest),
an answer (a slice's labels) altered where it is produced.  The sound run beside them comes
out correct, so it is the fault that fails the check.  The controls (the
reference in the next precision below the configuration's, in the
program's place) come out not correct too.
"""

from __future__ import annotations

import pytest

from benchmark import cells, judge, run
from benchmark.reference import pnp_adanet as ref
from benchmark.spec import Spec
from benchmark.tests.tiny import make_root

SEED = 2**33 + 17
# the adaptation cell needs 128 x 128 slices (see tiny.make_root)
CELLS = {"ct2mri.source": 32, "mri2ct.adapt": 128, "ct2mri.serve": 32,
         "mri2ct.serve": 32}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    return {size: Spec(make_root(tmp, size)) for size in set(CELLS.values())}


def _run(roots, cell):
    return run.run_cell(roots[CELLS[cell]], cell, SEED, 0.3, False,
                        device="cpu")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(roots, cell):
    out = _run(roots, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _unchanged(make):
    def make_step(cfg, **kw):
        step = make(cfg, **kw)

        def broken(state, batch, seed):
            _, metrics = step(state, batch, seed)
            return state, metrics
        return broken
    return make_step


@pytest.mark.parametrize("cell", ["ct2mri.source", "mri2ct.adapt"])
def test_a_step_that_returns_its_state_unchanged(roots, cell, monkeypatch):
    from mcmda_tpu_torch.train import adapt, source
    mod = adapt if cell.endswith("adapt") else source
    name = "make_adapt_step" if mod is adapt else "make_train_step"
    monkeypatch.setattr(mod, name, _unchanged(getattr(mod, name)))
    out = _run(roots, cell)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["ct2mri.source", "mri2ct.adapt"])
def test_half_of_each_batch_left_out(roots, cell, monkeypatch):
    from mcmda_tpu_torch.data import pipeline
    sample = pipeline.sample_device_batch

    def half(data, gen, batch_size, num_classes=None):
        b = sample(data, gen, batch_size, num_classes)
        return {k: v[:batch_size // 2] for k, v in b.items()}
    monkeypatch.setattr(pipeline, "sample_device_batch", half)
    assert not _run(roots, cell)["correct"]


@pytest.mark.parametrize("cell", ["ct2mri.serve", "mri2ct.serve"])
def test_an_answer_altered_where_it_is_produced(roots, cell, monkeypatch):
    from mcmda_tpu_torch.evaluation import inference
    predict = inference.predict_volume

    def altered(*a, **kw):   # one slice's labels, the answer for it
        out = predict(*a, **kw).copy()
        out[1] = (out[1] + 1) % 5
        return out
    monkeypatch.setattr(inference, "predict_volume", altered)
    assert not _run(roots, cell)["correct"]


@pytest.mark.parametrize("cell", ["ct2mri.serve", "mri2ct.serve"])
def test_half_of_each_volume_left_out(roots, cell, monkeypatch):
    from mcmda_tpu_torch.evaluation import inference
    predict = inference.predict_volume

    def half(forward, volume, **kw):
        out = predict(forward, volume, **kw).copy()
        s = out.shape[0] // 2
        out[s:] = out[:out.shape[0] - s]
        return out
    monkeypatch.setattr(inference, "predict_volume", half)
    assert not _run(roots, cell)["correct"]


@pytest.mark.parametrize("cell", ["ct2mri.source", "mri2ct.adapt"])
def test_the_tf32_control_is_not_correct(roots, cell):
    spec = roots[CELLS[cell]]
    w = spec.cell(cell)
    c = cells.make(spec.config(w["config"]), spec.traffic(w["traffic"]),
                   SEED, "cpu")
    control = c.readings(c.reference(), c.reference(ref.tf32_round))
    assert not judge.verdict(control, spec.limits(cell))[0]


@pytest.mark.parametrize("cell", ["ct2mri.serve", "mri2ct.serve"])
def test_the_fp8_control_is_not_correct(roots, cell):
    spec = roots[CELLS[cell]]
    w = spec.cell(cell)
    c = cells.make(spec.config(w["config"]), spec.traffic(w["traffic"]),
                   SEED, "cpu")
    readings, bad = c.serve_readings(c.reference_probs(),
                                     c.control_masks(ref.fp8_round))
    assert bad == 0
    assert not judge.verdict(readings, spec.limits(cell))[0]


class _Replayed:
    """On the CPU, a CUDA graph step's calls as the check sees them:
    ``inner`` steps a call (settable), step ``i`` seeded
    ``prng.inner_key(seed, i, inner)``; ``one_seed`` draws every step of
    a call from the seed of its first (a fault)."""

    one_seed = False

    def __init__(self, step_fn, inner, **_):
        self.step_fn, self.inner, self.graph = step_fn, inner, None

    def __call__(self, state, batch, seed):
        from mcmda_tpu_torch.utils import prng
        self.graph = True
        for i in range(self.inner):
            state, metrics = self.step_fn(state, batch, prng.inner_key(
                seed, 0 if self.one_seed else i, self.inner))
        return state, metrics


@pytest.mark.parametrize("cell,one_seed", [("ct2mri.source", False),
                                           ("ct2mri.source", True),
                                           ("mri2ct.adapt", False)])
def test_calls_of_several_replays_follow_the_windows_seeding(
        roots, cell, one_seed, monkeypatch):
    """The check's calls of one and two steps, as on the card, against the
    reference's seeds; a call whose steps all draw its first seed is not
    correct (T1's ``loss_gap`` holds the seeding that both steps share)."""
    from mcmda_tpu_torch.train import loop
    monkeypatch.setattr(cells, "graphed", lambda device: True)
    monkeypatch.setattr(_Replayed, "one_seed", one_seed)
    monkeypatch.setattr(loop, "scanned_step", _Replayed)
    out = _run(roots, cell)
    assert out["correct"] != one_seed, out["checks"]
