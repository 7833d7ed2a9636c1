"""The port's seed sweeps held against the JAX package's, per distribution.

For each direction it reads the port's artifact
(``results/torch_h100/<direction>_seed_sweep.json``, written by
``seed_sweep.py`` on the card) and the reference's per-seed rows (mri2ct:
``results/mri2ct_seed_sweep_r5.json``; ct2mri: its 15 seeds pooled from
``results/ct2mri_seed_sweep_r5.json`` and
``results/ct2mri_policyval_sweep.json``), and runs an exact two-sided
permutation test of the difference of means on each gated metric: every
split of the pooled values into groups of the two sizes, C(10, 5) = 252
for 5 seeds against 5.  Parity holds when p >= ALPHA for both gated
metrics (0.05 split over the two).  The other metrics are reported beside
the reference's, without a gate.

Usage (from the root of a checkout; numpy and json only)::

    python -m mcmda_tpu_torch.scripts.sweep_parity
"""

from __future__ import annotations

import argparse
import itertools
import json
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
# the checkpoint the recipe ships, and the training dynamics apart from
# selection; each held at ALPHA = 0.05 / 2
GATED = ("selected_cr_ent", "oracle")
ALPHA = 0.025
# reported beside the reference's, no gate
REPORTED = ("final", "selected", "selected_cr", "selected_dual", "tta_live",
            "ema0.9", "ema0.95", "ema0.9g0.25", "ema0.95g0.25")


def permutation_p(a, b) -> float:
    """Exact two-sided permutation p of the difference of means of ``a``
    and ``b``: the share of the C(n, len(a)) splits of the pooled values
    whose |difference of means| is at least the observed one (ties within
    1e-9 of it count)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    pooled = np.concatenate([a, b])
    n, k = pooled.size, a.size
    observed = abs(a.mean() - b.mean())
    picks = np.array(list(itertools.combinations(range(n), k)))
    s_a = pooled[picks].sum(1)
    diff = np.abs(s_a / k - (pooled.sum() - s_a) / (n - k))
    return float(np.mean(diff >= observed - 1e-9 * max(1.0, observed)))


def _load(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def per_seed(rows, key) -> list:
    """One value per seed: ``tta_live`` is the live state's flip-TTA Dice."""
    if key == "tta_live":
        return [r["tta"]["live"] for r in rows]
    return [r[key] for r in rows]


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
    return {"n": int(v.size), "mean": round(float(v.mean()), 4),
            "std": round(float(v.std(ddof=1)), 4) if v.size > 1 else None}


def compare(direction) -> dict:
    """Per metric: the port's and the reference's n / mean / sample std,
    the port's std over the reference's, and (gated metrics) p and the
    verdict."""
    port = port_artifact(direction)["per_seed"]
    ref = reference_rows(direction)
    out = {}
    for key in GATED + REPORTED:
        a, b = per_seed(port, key), per_seed(ref, key)
        row = {"port": _stats(a), "reference": _stats(b)}
        if row["port"]["std"] and row["reference"]["std"]:
            row["std_ratio"] = round(row["port"]["std"]
                                     / row["reference"]["std"], 3)
        if key in GATED:
            row["p"] = round(permutation_p(a, b), 4)
            row["parity"] = row["p"] >= ALPHA
        out[key] = row
    out["no_adapt"] = {"port": port_artifact(direction)["no_adapt"],
                       "reference": reference_no_adapt(direction)}
    return out


def main(argv=None) -> dict:
    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args(argv)
    result = {d: compare(d) for d in REFERENCE
              if os.path.exists(os.path.join(ROOT, PORT.format(d)))}
    print("| Direction | Metric | Port n, mean ± std | Reference n, mean ± "
          "std | std port / ref | p (exact) |")
    print("|---|---|---|---|---|---|")
    for d, rows in result.items():
        for key, row in rows.items():
            if key == "no_adapt":
                print(f"| {d} | no_adapt | {row['port']} | "
                      f"{', '.join(map(str, row['reference']))} | - | - |")
                continue
            pt, rf = row["port"], row["reference"]
            gate = (f"{row['p']} ({'parity' if row['parity'] else 'FAIL'})"
                    if "p" in row else "-")
            print(f"| {d} | {key} | {pt['n']}, {pt['mean']} ± {pt['std']} | "
                  f"{rf['n']}, {rf['mean']} ± {rf['std']} | "
                  f"{row.get('std_ratio', '-')} | {gate} |")
    for d in result:
        print(f"{d}: the port's sweep ran on {port_artifact(d)['card']}")
    return result


if __name__ == "__main__":
    main()
