"""The port's seed sweeps held against the JAX package's, per distribution.

For each direction it reads the port's artifact
(``results/torch_h100/<direction>_seed_sweep.json``, written by
``seed_sweep.py`` on the card) and the reference's per-seed rows (mri2ct:
``results/mri2ct_seed_sweep_r5.json``; ct2mri: its 15 seeds pooled from
``results/ct2mri_seed_sweep_r5.json`` and
``results/ct2mri_policyval_sweep.json``), and runs a two-sided
permutation test of the difference of means on each gated metric: every
split of the pooled values into groups of the two sizes where there are
at most EXACT_MAX of them (C(10, 5) = 252 for mri2ct's 5 seeds against
5), else a seeded Monte Carlo of DRAWS random splits (C(30, 15) =
155,117,520 for ct2mri's 15 against 15; standard error ~1.6e-4 at p =
0.025).  Parity holds when p >= ALPHA for both gated metrics (0.05 split
over the two).  The other metrics are reported beside the reference's
with their p and without a gate, each over the rows that have it:
``gap.tta_sel`` is flip TTA at the cr_ent pick (what ``run.eval_tta:
flip`` ships), and ct2mri's reference rows of seeds 0-2 have no
``selected_cfg``.

Also without a gate: where the reference pools several artifacts, each
artifact's seeds against the other's and against the port's seeds of the
same range (``splits``), and the port's source draws
(``results/torch_h100/<direction>_source_seed<N>_sweep.json``, one
``--set run.seed=N`` each, beside the main sweep's adaptation seed 0)
with their spread next to the spread over adaptation seeds
(``source_draws``); and the reference's ct2mri sweeps from other
source states (CONTEXT: ``results/ct2mri_nhwc_sweep.json``, the r2
recipe's ``results/ct2mri_seed_sweep.json``) beside its gated pool, each
with its no-adapt Dice (``reference_context``).  A 20,000-step retrain of
the main sweep's source (RETRAIN, the figures its run printed) is printed
against the main sweep's digest.

Usage (from the root of a checkout; numpy and json only)::

    python -m mcmda_tpu_torch.scripts.sweep_parity
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import math
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REFERENCE = {
    "mri2ct": ("results/mri2ct_seed_sweep_r5.json",),
    "ct2mri": ("results/ct2mri_seed_sweep_r5.json",
               "results/ct2mri_policyval_sweep.json"),
}
PORT = "results/torch_h100/{}_seed_sweep.json"
# the port's sweeps of other source draws (``--set run.seed=N``)
DRAWS_GLOB = "results/torch_h100/{}_source_seed*_sweep.json"
# the reference's sweeps of other source states, on recipes that cannot
# join the gated pool, and the pool itself: (label, files); no gate
CONTEXT = {"ct2mri": (
    ("nhwc thin layout", ("results/ct2mri_nhwc_sweep.json",)),
    ("r2 recipe, superseded", ("results/ct2mri_seed_sweep.json",)),
    ("the gated pool", REFERENCE["ct2mri"]),
)}
# a retrain of the main ct2mri sweep's source state (run.seed 0): the card,
# steps, seconds, digest and no-adapt Dice that its seed_sweep --seeds 0
# run printed, and whether the digest is the main sweep's
RETRAIN = "results/torch_h100/{}_source_retrain.json"
# the checkpoint the recipe ships, and the training dynamics apart from
# selection; each held at ALPHA = 0.05 / 2
GATED = ("selected_cr_ent", "oracle")
ALPHA = 0.025
# reported beside the reference's, no gate
REPORTED = ("final", "selected", "selected_cr", "selected_dual", "tta_live",
            "gap.tta_sel", "selected_cfg", "ema0.9", "ema0.95", "ema0.9g0.25",
            "ema0.95g0.25")


# splits enumerated up to this many; above it (C(30, 15) = 155,117,520
# for 15 seeds against 15) a seeded Monte Carlo of DRAWS random splits,
# CHUNK at a time (~60 MB at 30 values)
EXACT_MAX = 2_000_000
DRAWS = 1_000_000
CHUNK = 100_000


def permutation_p(a, b, exact_max=EXACT_MAX, seed=0) -> float:
    """Two-sided permutation p of the difference of means of ``a`` and
    ``b``.  Exact where C(n, len(a)) <= ``exact_max``: the share of the
    splits of the pooled values whose |difference of means| is at least the
    observed one (ties within 1e-9 of it count).  Above it, DRAWS
    uniformly random splits from ``seed``: (hits + 1) / (DRAWS + 1), whose
    standard error is about sqrt(p (1 - p) / DRAWS)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    pooled = np.concatenate([a, b])
    n, k = pooled.size, a.size
    observed = abs(a.mean() - b.mean())
    floor = observed - 1e-9 * max(1.0, observed)
    total = pooled.sum()

    def hits(picks):
        s_a = pooled[picks].sum(1)
        return np.abs(s_a / k - (total - s_a) / (n - k)) >= floor

    if math.comb(n, k) <= exact_max:
        return float(np.mean(hits(np.array(
            list(itertools.combinations(range(n), k))))))
    rng = np.random.default_rng(seed)
    count = 0
    for start in range(0, DRAWS, CHUNK):
        m = min(CHUNK, DRAWS - start)
        # the k smallest of n uniform keys per row: a uniform k-subset
        picks = np.argpartition(rng.random((m, n)), k - 1, axis=1)[:, :k]
        count += int(np.count_nonzero(hits(picks)))
    return (count + 1) / (DRAWS + 1)


def _load(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def _value(row, key):
    """``key``'s value in one row, None where the row lacks it:
    ``tta_live`` is the live state's flip-TTA Dice, ``gap.<k>`` the row's
    ``gap[k]``."""
    if key == "tta_live":
        return row.get("tta", {}).get("live")
    if key.startswith("gap."):
        return row.get("gap", {}).get(key[len("gap."):])
    return row.get(key)


def per_seed(rows, key) -> list:
    """One value per seed whose row has ``key``; a gated key must be in
    every row."""
    values = per_seed_values(rows, key)
    if key in GATED and len(values) < len(rows):
        raise KeyError(f"{key} is missing from a row")
    return values


def per_seed_values(rows, key) -> list:
    """``key``'s values over the rows that have it (no gate)."""
    return [v for v in (_value(r, key) for r in rows) if v is not None]


def reference_rows(direction) -> list:
    """The reference's per-seed rows of ``direction``, seeds pooled and in
    order."""
    rows = [r for rel in REFERENCE[direction] for r in _load(rel)["per_seed"]]
    return sorted(rows, key=lambda r: r["seed"])


def reference_no_adapt(direction) -> list:
    return sorted({_load(rel)["no_adapt"] for rel in REFERENCE[direction]})


def port_artifact(direction) -> dict:
    return _load(PORT.format(direction))


def _stats(v) -> dict:
    v = np.asarray(v, np.float64)
    if not v.size:
        return {"n": 0, "mean": None, "std": None}
    return {"n": int(v.size), "mean": round(float(v.mean()), 4),
            "std": round(float(v.std(ddof=1)), 4) if v.size > 1 else None}


def _shown(p) -> float:
    """p to 4 places, or to 2 significant figures where 4 places read
    below 0.001."""
    return round(p, 4) if p >= 0.001 else float(f"{p:.2g}")


def compare(direction) -> dict:
    """Per metric: the port's and the reference's n / mean / sample std,
    the port's std over the reference's and p to 4 places (``p_sig``, to 2
    significant figures, where that reads below 0.001); the gated metrics
    also the verdict, p >= ALPHA."""
    port = port_artifact(direction)["per_seed"]
    ref = reference_rows(direction)
    out = {}
    for key in GATED + REPORTED:
        a, b = per_seed(port, key), per_seed(ref, key)
        row = {"port": _stats(a), "reference": _stats(b)}
        if row["port"]["std"] and row["reference"]["std"]:
            row["std_ratio"] = round(row["port"]["std"]
                                     / row["reference"]["std"], 3)
        if key in GATED or (len(a) > 1 and len(b) > 1):
            p = permutation_p(a, b)
            row["p"] = round(p, 4)
            if row["p"] < 0.001:  # 4 places hide it
                row["p_sig"] = _shown(p)
        if key in GATED:
            row["parity"] = row["p"] >= ALPHA
        out[key] = row
    out["no_adapt"] = {"port": port_artifact(direction)["no_adapt"],
                       "reference": reference_no_adapt(direction)}
    return out


def _span(rows) -> str:
    seeds = [r["seed"] for r in rows]
    return f"{min(seeds)}-{max(seeds)}"


def splits(direction) -> list:
    """Without a gate, where the reference pools several artifacts: each
    artifact's seeds against each other's, and the port's seeds of each
    artifact's range against each artifact and against each other.  One
    row per pair and gated metric: (sample a, sample b, metric, n a, n b,
    p)."""
    parts = [sorted(_load(rel)["per_seed"], key=lambda r: r["seed"])
             for rel in REFERENCE[direction]]
    if len(parts) < 2:
        return []
    port = port_artifact(direction)["per_seed"]
    groups = {f"reference seeds {_span(p)}": p for p in parts}
    for p in parts:
        seeds = {r["seed"] for r in p}
        mine = [r for r in port if r["seed"] in seeds]
        if len(mine) > 1:
            groups[f"port seeds {_span(mine)}"] = mine
    names = list(groups)
    out = []
    for i, x in enumerate(names):
        for y in names[i + 1:]:
            for key in GATED:
                a, b = per_seed(groups[x], key), per_seed(groups[y], key)
                out.append((x, y, key, len(a), len(b),
                            _shown(permutation_p(a, b))))
    return out


def _run_seed(art, direction) -> int:
    """The source draw of a sweep: its ``run.seed`` override, else the
    config's."""
    for o in art["overrides"]:
        if o.startswith("run.seed="):
            return int(o.split("=", 1)[1])
    return _load(f"configs/{direction}.json").get("run", {}).get("seed", 0)


def source_draws(direction) -> list:
    """One row per source draw of the port (``run.seed``): the main
    sweep's adaptation seed 0 and each
    ``results/torch_h100/<direction>_source_seed<N>_sweep.json``; no gate
    (the reference holds one draw)."""
    files = sorted(glob.glob(os.path.join(ROOT, DRAWS_GLOB.format(
        direction))))
    rows = []
    for art in [port_artifact(direction)] + [_load(f) for f in files]:
        r0 = next(r for r in art["per_seed"] if r["seed"] == 0)
        rows.append({"run_seed": _run_seed(art, direction),
                     "digest": art["settings"]["source_digest"],
                     "no_adapt": art["no_adapt"],
                     "selected_cr_ent": r0["selected_cr_ent"],
                     "oracle": round(r0["oracle"], 4)})
    return sorted(rows, key=lambda r: r["run_seed"])


def reference_context(direction) -> list:
    """One row per CONTEXT entry: its files, commits, overrides (None
    where the artifact has no such key), seeds, no-adapt Dice, and n /
    mean / sample std of ``oracle`` and of ``selected_cr_ent`` (n 0 where
    the rows lack it); no gate."""
    rows = []
    for label, files in CONTEXT.get(direction, ()):
        arts = [_load(rel) for rel in files]
        per_seed = [r for a in arts for r in a["per_seed"]]
        rows.append({
            "label": label, "files": list(files),
            "commits": [a.get("commit") for a in arts],
            "overrides": [a.get("overrides") for a in arts],
            "seeds": len(per_seed),
            "no_adapt": sorted({a["no_adapt"] for a in arts}),
            "oracle": _stats(per_seed_values(per_seed, "oracle")),
            "selected_cr_ent": _stats(per_seed_values(per_seed,
                                                      "selected_cr_ent")),
        })
    return rows


def _spread(v) -> str:
    v = np.asarray(v, np.float64)
    return (f"{v.min():.4f}-{v.max():.4f} (range {v.max() - v.min():.4f}, "
            f"std {v.std(ddof=1):.4f})" if v.size > 1 else "-")


def main(argv=None) -> dict:
    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args(argv)
    result = {d: compare(d) for d in REFERENCE
              if os.path.exists(os.path.join(ROOT, PORT.format(d)))}
    print("| Direction | Metric | Port n, mean ± std | Reference n, mean ± "
          "std | std port / ref | p |")
    print("|---|---|---|---|---|---|")
    for d, rows in result.items():
        for key, row in rows.items():
            if key == "no_adapt":
                print(f"| {d} | no_adapt | {row['port']} | "
                      f"{', '.join(map(str, row['reference']))} | - | - |")
                continue
            pt, rf = row["port"], row["reference"]
            pv = row.get("p_sig", row.get("p"))
            gate = (f"{pv} ({'parity' if row['parity'] else 'FAIL'})"
                    if "parity" in row else
                    f"{pv} (no gate)" if "p" in row else "-")
            print(f"| {d} | {key} | {pt['n']}, {pt['mean']} ± {pt['std']} | "
                  f"{rf['n']}, {rf['mean']} ± {rf['std']} | "
                  f"{row.get('std_ratio', '-')} | {gate} |")
    for d in result:
        print(f"{d}: the port's sweep ran on {port_artifact(d)['card']}")
    for d in result:
        apart, draws = splits(d), source_draws(d)
        result[d] = {**result[d], "splits": apart, "source_draws": draws}
        if apart:
            print(f"\n{d}, the pooled artifacts' seeds apart (no gate)\n")
            print("| Sample | Against | Metric | n | p |")
            print("|---|---|---|---|---|")
            for x, y, key, na, nb, p in apart:
                print(f"| {x} | {y} | {key} | {na} / {nb} | {p} |")
        if len(draws) > 1:
            print(f"\n{d}, the port's source draws at adaptation seed 0 "
                  "(no gate)\n")
            print("| run.seed | source digest | no_adapt | selected_cr_ent "
                  "| oracle |")
            print("|---|---|---|---|---|")
            for r in draws:
                print(f"| {r['run_seed']} | {r['digest'][:8]} | "
                      f"{r['no_adapt']} | {r['selected_cr_ent']} | "
                      f"{r['oracle']} |")
            for key in ("no_adapt", "selected_cr_ent", "oracle"):
                print(f"over {len(draws)} draws, {key}: "
                      + _spread([r[key] for r in draws]))
            seeds = port_artifact(d)["per_seed"]
            for key in GATED:
                print(f"over {len(seeds)} adaptation seeds of draw "
                      f"{draws[0]['run_seed']}, {key}: "
                      + _spread(per_seed(seeds, key)))
        context = reference_context(d)
        result[d]["reference_context"] = context
        if context:
            print(f"\n{d}, the reference's sweeps from other source states "
                  "(no gate; sample stds)\n")
            print("| Sweep | Files | Commit | Overrides | Seeds | no_adapt | "
                  "oracle | selected_cr_ent |")
            print("|---|---|---|---|---|---|---|---|")
            for r in context:
                cells = [f"{s['mean']} ± {s['std']}" if s["n"] else "-"
                         for s in (r["oracle"], r["selected_cr_ent"])]
                print(f"| {r['label']} | {', '.join(r['files'])} | "
                      f"{', '.join(str(c) for c in r['commits'])} | "
                      f"{', '.join(str(o) for o in r['overrides'])} | "
                      f"{r['seeds']} | "
                      f"{', '.join(map(str, r['no_adapt']))} | "
                      f"{cells[0]} | {cells[1]} |")
        retrain = os.path.join(ROOT, RETRAIN.format(d))
        if os.path.exists(retrain):
            rec = _load(RETRAIN.format(d))
            result[d]["retrain"] = rec
            print(f"\n{d}: a {rec['source_steps']}-step retrain of the main "
                  f"sweep's source on {rec['card']} ({rec['source_seconds']} "
                  f"s): digest {rec['source_digest'][:8]}..., "
                  + ("equal to" if rec["digest_equal"] else "not")
                  + f" the main sweep's {rec['main_sweep_digest'][:8]}...; "
                  f"no-adapt {rec['no_adapt_printed']}")
    return result


if __name__ == "__main__":
    main()
