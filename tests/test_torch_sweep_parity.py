"""The port's full-length seed sweeps on the card held against the JAX
package's, per distribution (numpy and json only; the artifacts are
committed).  The permutation helper against known cases (exact, and its
Monte Carlo branch against the exact p), the parity gate per direction and
metric, the measured p pinned, and the artifacts' provenance: seeds,
lengths, cadence, card and one source run per sweep, one source draw per
``run.seed`` file."""

import hashlib
import itertools
import json

import numpy as np
import pytest

from mcmda_tpu_torch.scripts import sweep_parity as sp

# the shipped lengths and each direction's probe cadence
# (``adapt.select_every``: 250 for mri2ct, the config's 100 for ct2mri)
LENGTHS = {"mri2ct": (20000, 10000, 250), "ct2mri": (20000, 10000, 100)}
# the seeds of each committed port sweep
SWEEPS = {"mri2ct": 5, "ct2mri": 15}
# the sweeps held to the parity gate.  ct2mri's 15 seeds against the
# reference's 15 fail on both gated metrics (selected_cr_ent p 0.0002,
# oracle p 0.0000, the port above the reference): an open finding
# (ROADMAP.md, queue 3), so it is not gated and its p is pinned below
SEEDS = {"mri2ct": 5}
# the measured p of every gated metric, to 4 places and, where those read
# below 0.001, to 2 significant figures, so that a finding cannot drift
# (ct2mri's 15 against 15: the Monte Carlo of seed 0)
PINNED = {("mri2ct", "selected_cr_ent"): (0.3016, None),
          ("mri2ct", "oracle"): (0.5317, None),
          ("ct2mri", "selected_cr_ent"): (0.0002, 0.00023),
          ("ct2mri", "oracle"): (0.0, 2.6e-05)}
# the source state of each sweep (sha256 of params then BN state)
DIGESTS = {
    "mri2ct": "db69532a4a21bacc06dd7193f85a775c"
              "303f46883a0c640d9225139dfc21e7a6",
    "ct2mri": "01bb7e1fafd88e4113cb57b0e79dcf68"
              "cb003388775bc61b8124adbfd6d5bd31",
}
# sha256 of the sorted-key JSON of ct2mri's rows and curves of seeds 0-4
# as their first calls wrote them: seeds added later leave them as they were
CT2MRI_FIRST_ROWS = ("fe329505291193a4b1b4841fc66c06b6"
                     "4917c7ab6f41ec408f3aa268966d358d")
# the port's other source draws of ct2mri (``--set run.seed=N``), each a
# source run and adaptation seed 0
DRAWS = (1, 2, 3)
# each draw's (no-adapt Dice, selected_cr_ent, oracle) at adaptation seed
# 0, run.seed 0 the main sweep's
DRAW_FIGURES = {0: (0.3164, 0.8058, 0.8243), 1: (0.3099, 0.5599, 0.6025),
                2: (0.3234, 0.5811, 0.6302), 3: (0.3179, 0.6273, 0.6989)}
# the decision rule over the four draws (PERF.md, section 6): (a) both of the
# reference pool's means inside [min, max] of the draws; (b) every draw's
# no-adapt Dice above RULE_B_LEVEL, the highest of the reference's three
# source states
RULE = {"a": True, "b": True}
RULE_B_LEVEL = 0.2769
# the digest that a 20,000-step retrain of ct2mri's run.seed 0 printed on
# an H100: the main sweep's
RETRAIN_DIGEST = DIGESTS["ct2mri"]


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


def _samples(case):
    """(a, b) of a Monte Carlo case: seeded 10 against 10 at three shifts,
    and ct2mri's port seeds 0-4 against the reference's 15 (oracle)."""
    if case == "ct2mri":
        port = [r for r in sp.port_artifact("ct2mri")["per_seed"]
                if r["seed"] < 5]
        return (sp.per_seed(port, "oracle"),
                sp.per_seed(sp.reference_rows("ct2mri"), "oracle"))
    rng = np.random.default_rng(case)
    return (np.round(rng.uniform(0.5, 0.9, 10), 4),
            np.round(rng.uniform(0.5, 0.9, 10) + 0.04 * case, 4))


@pytest.mark.parametrize("case", [0, 1, 2, "ct2mri"])
def test_permutation_p_monte_carlo_matches_exact(case):
    """With the threshold forced below the count of splits, the seeded
    Monte Carlo lands within 4 standard errors of the exact p."""
    a, b = _samples(case)
    exact = sp.permutation_p(a, b)
    mc = sp.permutation_p(a, b, exact_max=0)
    se = np.sqrt(exact * (1 - exact) / sp.DRAWS) + 1 / sp.DRAWS
    assert abs(mc - exact) <= 4 * se, (exact, mc, se)


def test_permutation_p_monte_carlo_is_seeded():
    """One seed gives one p, run to run; another seed agrees within 4
    standard errors; 15 against 15 takes the Monte Carlo by default."""
    a, b = _samples(1)
    p0 = sp.permutation_p(a, b, exact_max=0, seed=0)
    assert sp.permutation_p(a, b, exact_max=0, seed=0) == p0
    p1 = sp.permutation_p(a, b, exact_max=0, seed=1)
    assert abs(p1 - p0) <= 4 * np.sqrt(2 * p0 * (1 - p0) / sp.DRAWS)
    # 15 against 15 is above the threshold: (hits + 1) / (DRAWS + 1)
    a, b = np.linspace(0.6, 0.7, 15), np.linspace(0.65, 0.75, 15)
    p = sp.permutation_p(a, b)
    assert p == sp.permutation_p(a, b)
    assert round(p * (sp.DRAWS + 1)) == pytest.approx(p * (sp.DRAWS + 1))


@pytest.fixture(scope="module")
def compared():
    return {d: sp.compare(d) for d in sp.REFERENCE}


@pytest.mark.parametrize("direction, metric", sorted(PINNED))
def test_gated_p_is_pinned(compared, direction, metric):
    """The measured p of each gated metric as ``compare`` gives it, and
    its verdict."""
    row = compared[direction][metric]
    assert (row["p"], row.get("p_sig")) == PINNED[direction, metric]
    assert row["parity"] == (direction in SEEDS)


@pytest.mark.parametrize("direction", sorted(SEEDS))
@pytest.mark.parametrize("metric", sp.GATED)
def test_port_sweep_within_the_reference_spread(direction, metric):
    """The port's per-seed values against the reference's: exact
    two-sided permutation test of the difference of means, p >= 0.025."""
    port = sp.per_seed(sp.port_artifact(direction)["per_seed"], metric)
    ref = sp.per_seed(sp.reference_rows(direction), metric)
    p = sp.permutation_p(port, ref)
    assert p >= sp.ALPHA, (direction, metric, np.mean(port), np.mean(ref), p)


@pytest.mark.parametrize("direction", sorted(SWEEPS))
def test_port_sweep_artifact_provenance(direction):
    """Seeds 0..n-1, contiguous, at the shipped lengths and cadence, on an
    H100, from one source run, with the reference's per-seed keys."""
    art = sp.port_artifact(direction)
    assert art["direction"] == direction
    assert art["overrides"] == ["segmenter.train_fused=pallas"]
    assert [r["seed"] for r in art["per_seed"]] == \
        list(range(SWEEPS[direction]))
    assert art["seeds"] == SWEEPS[direction]
    assert sorted(art["curves"], key=int) == \
        [str(s) for s in range(SWEEPS[direction])]
    st = art["settings"]
    assert (st["source_steps"], st["adapt_steps"], st["eval_every"]) == \
        LENGTHS[direction]
    assert st["source_digest"] == DIGESTS[direction]
    assert "H100" in art["card"]
    if direction == "ct2mri":
        blob = {"per_seed": art["per_seed"][:5],
                "curves": {str(s): art["curves"][str(s)] for s in range(5)}}
        assert hashlib.sha256(json.dumps(blob, sort_keys=True).encode()) \
            .hexdigest() == CT2MRI_FIRST_ROWS
    ev = LENGTHS[direction][2]
    for curve in art["curves"].values():
        assert [c["step"] for c in curve] == \
            list(range(ev, LENGTHS[direction][1] + 1, ev))
    ref_keys = set(sp.reference_rows(direction)[0])
    for row in art["per_seed"]:
        assert ref_keys <= set(row)
        # the pick's Dice is read from the curve, rounded to 4 places as
        # the JAX script rounds it; the oracle is kept unrounded
        assert 0.0 <= row["selected_cr_ent"] <= round(row["oracle"], 4) \
            <= 1.0


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


def test_per_seed_reads_gap_keys_and_skips_rows_without_a_reported_key():
    rows = [{"seed": 0, "oracle": 0.8, "gap": {"tta_sel": 0.7},
             "tta": {"live": 0.6}},
            {"seed": 1, "oracle": 0.9, "gap": {}, "selected_cfg": 0.5,
             "tta": {"live": 0.65}}]
    assert sp.per_seed(rows, "gap.tta_sel") == [0.7]
    assert sp.per_seed(rows, "selected_cfg") == [0.5]
    assert sp.per_seed(rows, "tta_live") == [0.6, 0.65]
    assert sp.per_seed(rows, "oracle") == [0.8, 0.9]
    assert sp.per_seed(rows, "final") == []
    assert sp._stats([]) == {"n": 0, "mean": None, "std": None}


@pytest.mark.parametrize("metric", sp.GATED)
def test_per_seed_refuses_a_row_without_a_gated_key(metric):
    rows = [{"seed": 0, metric: 0.8}, {"seed": 1}]
    with pytest.raises(KeyError, match=metric):
        sp.per_seed(rows, metric)


@pytest.mark.parametrize("key, n, mean, std", [
    ("gap.tta_sel", 15, 0.6756, 0.0958),
    ("selected_cfg", 12, 0.611, 0.0869),
])
def test_ct2mri_reference_reports_the_shipped_figure(key, n, mean, std):
    """ct2mri ships flip TTA at the cr_ent pick (``gap.tta_sel``) over its
    15 seeds; ``selected_cfg`` is in the rows of seeds 3-14 only (the r5
    script wrote it from seed 3 on), so it is reported over those."""
    rows = sp.reference_rows("ct2mri")
    v = sp.per_seed(rows, key)
    assert len(v) == n
    assert [r["seed"] for r in rows if sp._value(r, key) is not None] == \
        list(range(15 - n, 15))
    assert round(float(np.mean(v)), 4) == mean
    assert round(float(np.std(v, ddof=1)), 4) == std


@pytest.mark.parametrize("run_seed", DRAWS)
def test_source_draw_artifact_provenance(run_seed):
    """Each source draw: ``run.seed=N`` the one override beside the
    kernel path's, adaptation seed 0 at the shipped lengths and cadence,
    on an H100."""
    art = sp._load(sp.DRAWS_GLOB.replace("*", str(run_seed))
                   .format("ct2mri"))
    assert art["direction"] == "ct2mri"
    assert art["overrides"] == ["segmenter.train_fused=pallas",
                                f"run.seed={run_seed}"]
    assert [r["seed"] for r in art["per_seed"]] == [0]
    st = art["settings"]
    assert (st["source_steps"], st["adapt_steps"], st["eval_every"]) == \
        LENGTHS["ct2mri"]
    assert "H100" in art["card"]
    assert [c["step"] for c in art["curves"]["0"]] == \
        list(range(100, 10001, 100))


def test_source_draws_are_distinct_source_runs():
    """The draw table holds the main sweep's source (the config's
    ``run.seed`` 0) and one row per draw file, each its own source
    state."""
    rows = sp.source_draws("ct2mri")
    assert [r["run_seed"] for r in rows] == [0, *DRAWS]
    assert rows[0]["digest"] == DIGESTS["ct2mri"]
    assert len({r["digest"] for r in rows}) == len(rows)
    main = sp.port_artifact("ct2mri")["per_seed"][0]
    assert rows[0]["oracle"] == round(main["oracle"], 4)
    assert rows[0]["selected_cr_ent"] == main["selected_cr_ent"]


@pytest.fixture(scope="module")
def ct2mri_splits():
    return {(x, y, k): p for x, y, k, _, _, p in sp.splits("ct2mri")}


@pytest.mark.parametrize("a, b, metric, p", [
    ("reference seeds 0-4", "reference seeds 5-14", "selected_cr_ent",
     0.0966),
    ("reference seeds 0-4", "reference seeds 5-14", "oracle", 0.0256),
    ("reference seeds 0-4", "port seeds 0-4", "selected_cr_ent", 0.5),
    ("reference seeds 0-4", "port seeds 0-4", "oracle", 0.1587),
    ("reference seeds 5-14", "port seeds 0-4", "selected_cr_ent", 0.0093),
    ("reference seeds 5-14", "port seeds 0-4", "oracle", 0.0013),
    ("reference seeds 0-4", "port seeds 5-14", "selected_cr_ent", 0.0639),
    ("reference seeds 0-4", "port seeds 5-14", "oracle", 0.0456),
    ("reference seeds 5-14", "port seeds 5-14", "selected_cr_ent",
     4.3e-05),
    ("reference seeds 5-14", "port seeds 5-14", "oracle", 5.4e-05),
    ("port seeds 0-4", "port seeds 5-14", "selected_cr_ent", 0.2304),
    ("port seeds 0-4", "port seeds 5-14", "oracle", 0.326),
])
def test_ct2mri_splits_apart(ct2mri_splits, a, b, metric, p):
    """The reference's two ct2mri artifacts (one source state, one
    training code) against each other and against the port's seeds of
    each range, and the port's two ranges against each other: exact p,
    reported without a gate."""
    assert ct2mri_splits[a, b, metric] == p


def test_splits_need_a_pooled_reference():
    assert sp.splits("mri2ct") == []


@pytest.mark.parametrize("run_seed", sorted(DRAW_FIGURES))
def test_source_draw_figures_are_pinned(run_seed):
    """Each source draw's no-adapt Dice and adaptation seed 0's
    selected_cr_ent and oracle (to 4 places), so that the table the rule
    reads cannot drift."""
    row = {r["run_seed"]: r for r in sp.source_draws("ct2mri")}[run_seed]
    assert (row["no_adapt"], row["selected_cr_ent"], row["oracle"]) == \
        DRAW_FIGURES[run_seed]


def test_source_draw_decision_rule():
    """The rule fixed before draws 2-3 ran, on the four draws: (a) the
    reference pool's selected_cr_ent and oracle means both inside the
    draws' [min, max]; (b) every draw's no-adapt Dice above the highest of
    the reference's source states (its context table's no-adapt)."""
    rows = sp.source_draws("ct2mri")
    assert [r["run_seed"] for r in rows] == [0, 1, 2, 3]
    pool = sp.reference_rows("ct2mri")
    inside = []
    for key in sp.GATED:
        mean = float(np.mean(sp.per_seed(pool, key)))
        v = [r[key] for r in rows]
        inside.append(min(v) <= mean <= max(v))
    levels = [n for r in sp.reference_context("ct2mri")
              for n in r["no_adapt"]]
    assert max(levels) == RULE_B_LEVEL
    assert {"a": all(inside),
            "b": all(r["no_adapt"] > RULE_B_LEVEL for r in rows)} == RULE


@pytest.mark.parametrize("label, no_adapt, seeds, oracle, cr_ent", [
    ("nhwc thin layout", [0.2218], 3, (0.7569, 0.0898), None),
    ("r2 recipe, superseded", [0.2769], 5, (0.8276, 0.0275), None),
    ("the gated pool", [0.2066], 15, (0.7113, 0.0588), (0.6564, 0.0947)),
])
def test_reference_context_rows(label, no_adapt, seeds, oracle, cr_ent):
    """The reference's ct2mri sweeps from other source states beside its
    gated pool: no-adapt Dice, seeds and oracle (sample std) of each;
    selected_cr_ent only where the rows have it (the r5 script's)."""
    row = {r["label"]: r for r in sp.reference_context("ct2mri")}[label]
    assert row["no_adapt"] == no_adapt
    assert row["seeds"] == seeds
    assert (row["oracle"]["mean"], row["oracle"]["std"]) == oracle
    st = row["selected_cr_ent"]
    assert ((st["mean"], st["std"]) if st["n"] else None) == cr_ent
    if label == "the gated pool":
        assert row["files"] == list(sp.REFERENCE["ct2mri"])
        assert row["commits"] == ["0199708", "ff31301"]


def test_reference_context_is_ct2mri_only():
    assert sp.reference_context("mri2ct") == []
    assert [r["label"] for r in sp.reference_context("ct2mri")] == \
        [label for label, _ in sp.CONTEXT["ct2mri"]]


def test_retrain_artifact_pins_its_finding():
    """A 20,000-step source run at ct2mri's run.seed 0 on an H100: its
    digest and whether it is the main sweep's."""
    rec = sp._load(sp.RETRAIN.format("ct2mri"))
    assert rec["source_steps"] == LENGTHS["ct2mri"][0]
    assert "H100" in rec["card"]
    assert rec["source_digest"] == RETRAIN_DIGEST
    assert rec["main_sweep_digest"] == DIGESTS["ct2mri"]
    assert rec["digest_equal"] == (RETRAIN_DIGEST == DIGESTS["ct2mri"])


def test_main_prints_the_draws_the_context_and_the_retrain(monkeypatch,
                                                           capsys):
    """``main`` prints the source-draw table over run.seed 0-3, then the
    reference's context table and the retrain's line (the permutation
    test stubbed: its figures are pinned above)."""
    monkeypatch.setattr(sp, "permutation_p", lambda a, b, **kw: 0.5)
    result = sp.main([])
    out = capsys.readouterr().out
    draws = out.index("the port's source draws at adaptation seed 0")
    context = out.index("the reference's sweeps from other source states")
    retrain = out.index("-step retrain of the main sweep's source")
    assert draws < context < retrain
    for label, _ in sp.CONTEXT["ct2mri"]:
        assert f"| {label} |" in out[context:retrain]
    assert [r["run_seed"] for r in result["ct2mri"]["source_draws"]] == \
        [0, 1, 2, 3]
    assert result["mri2ct"]["reference_context"] == []
