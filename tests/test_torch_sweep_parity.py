"""The port's full-length seed sweeps on the card held against the JAX
package's, per distribution (numpy and json only; the artifacts are
committed).  The exact permutation helper against known cases, the parity
gate per direction and metric, and the artifacts' provenance: seeds,
lengths, cadence, card and one source run."""

import itertools

import numpy as np
import pytest

from mcmda_tpu_torch.scripts import sweep_parity as sp

# the shipped lengths and each direction's probe cadence
# (``adapt.select_every``: 250 for mri2ct, the config's 100 for ct2mri)
LENGTHS = {"mri2ct": (20000, 10000, 250), "ct2mri": (20000, 10000, 100)}
# the seeds of each committed port sweep.  ct2mri's has not run on the
# card yet (ROADMAP.md, queue 1 item 1): its cases join when
# results/torch_h100/ct2mri_seed_sweep.json lands with seeds 0-4
SEEDS = {"mri2ct": 5}


def _brute_force_p(a, b):
    """Every assignment of the pooled values to two groups of the sizes,
    one by one."""
    pooled = list(a) + list(b)
    obs = abs(np.mean(a) - np.mean(b))
    hits = total = 0
    for idx in itertools.combinations(range(len(pooled)), len(a)):
        ga = [pooled[i] for i in idx]
        gb = [pooled[i] for i in range(len(pooled)) if i not in idx]
        hits += abs(np.mean(ga) - np.mean(gb)) >= obs - 1e-12
        total += 1
    return hits / total


def test_permutation_p_identical_samples():
    assert sp.permutation_p([0.7] * 5, [0.7] * 5) == 1.0
    assert sp.permutation_p([0.1, 0.5, 0.9], [0.9, 0.5, 0.1]) == 1.0


def test_permutation_p_fully_separated():
    a = [0.61, 0.62, 0.63, 0.64, 0.65]
    b = [0.81, 0.82, 0.83, 0.84, 0.85]
    assert sp.permutation_p(a, b) == pytest.approx(2 / 252, abs=0)
    assert sp.permutation_p(b, a) == pytest.approx(2 / 252, abs=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_permutation_p_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    a = np.round(rng.uniform(0.5, 0.9, 4), 4)
    b = np.round(rng.uniform(0.5, 0.9, 5), 4)
    assert sp.permutation_p(a, b) == _brute_force_p(a, b)


@pytest.mark.parametrize("direction", sorted(SEEDS))
@pytest.mark.parametrize("metric", sp.GATED)
def test_port_sweep_within_the_reference_spread(direction, metric):
    """The port's per-seed values against the reference's: exact
    two-sided permutation test of the difference of means, p >= 0.025."""
    port = sp.per_seed(sp.port_artifact(direction)["per_seed"], metric)
    ref = sp.per_seed(sp.reference_rows(direction), metric)
    p = sp.permutation_p(port, ref)
    assert p >= sp.ALPHA, (direction, metric, np.mean(port), np.mean(ref), p)


@pytest.mark.parametrize("direction", sorted(SEEDS))
def test_port_sweep_artifact_provenance(direction):
    """Seeds 0..n-1, contiguous, at the shipped lengths and cadence, on an
    H100, from one source run, with the reference's per-seed keys."""
    art = sp.port_artifact(direction)
    assert art["direction"] == direction
    assert art["overrides"] == ["segmenter.train_fused=pallas"]
    assert [r["seed"] for r in art["per_seed"]] == \
        list(range(SEEDS[direction]))
    assert art["seeds"] == SEEDS[direction]
    assert sorted(art["curves"], key=int) == \
        [str(s) for s in range(SEEDS[direction])]
    st = art["settings"]
    assert (st["source_steps"], st["adapt_steps"], st["eval_every"]) == \
        LENGTHS[direction]
    assert len(st["source_digest"]) == 64
    assert "H100" in art["card"]
    ev = LENGTHS[direction][2]
    for curve in art["curves"].values():
        assert [c["step"] for c in curve] == \
            list(range(ev, LENGTHS[direction][1] + 1, ev))
    ref_keys = set(sp.reference_rows(direction)[0])
    for row in art["per_seed"]:
        assert ref_keys <= set(row)
        assert 0.0 <= row["selected_cr_ent"] <= row["oracle"] <= 1.0


@pytest.mark.parametrize("direction", sorted(sp.REFERENCE))
def test_reference_pool(direction):
    """The reference pools what the JAX package's tables pool: mri2ct
    seeds 0-4 (selected_cr_ent 0.8442), ct2mri its 15 live seeds
    (0.6564 +/- 0.0947, sample std), each from one source run."""
    rows = sp.reference_rows(direction)
    want = {"mri2ct": (5, 0.8442, 0.0274), "ct2mri": (15, 0.6564, 0.0947)}
    n, mean, std = want[direction]
    v = sp.per_seed(rows, "selected_cr_ent")
    assert [r["seed"] for r in rows] == list(range(n))
    assert round(float(np.mean(v)), 4) == mean
    assert round(float(np.std(v, ddof=1)), 4) == std
    assert len(sp.reference_no_adapt(direction)) == 1
