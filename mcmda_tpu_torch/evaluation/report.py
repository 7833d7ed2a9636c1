"""Evaluation report (counterpart of ``mcmda_tpu/evaluation/report.py``):
per-structure Dice, ASSD and HD95 averaged over volumes, printed in the
paper's format and returned as a dict."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from mcmda_tpu_torch.data.splits import STRUCTURES
from mcmda_tpu_torch.evaluation import inference, metrics3d


def _metrics_one(pred, lab, structures, sp):
    """Per-structure metrics for one volume, with total-miss ASSD penalty.

    Structures the model misses entirely (empty prediction, non-empty truth)
    have infinite ASSD; silently dropping them would optimistically bias the
    mean exactly for the worst predictions, so each miss instead contributes
    the volume diagonal (the worst finite surface distance possible in that
    volume) and is counted in ``assd_misses``."""
    pv = metrics3d.per_structure(pred, lab, structures, sp)
    diag = float(np.linalg.norm(
        np.asarray(lab.shape, np.float64)
        * (np.ones(3) if sp is None else np.asarray(sp, np.float64))))
    for name in structures.values():
        # assd and hd95 come from the same pooled distance arrays, so they
        # go infinite together (either surface empty)
        pv[name]["assd_miss"] = bool(np.isinf(pv[name]["assd"]))
        if pv[name]["assd_miss"]:
            pv[name]["assd"] = diag
            pv[name]["hd95"] = diag
    return pv


def _aggregate(per_vol, structures):
    agg = {}
    for name in structures.values():
        dices = [pv[name]["dice"] for pv in per_vol]
        assds = [pv[name]["assd"] for pv in per_vol
                 if np.isfinite(pv[name]["assd"])]  # nan = truth empty
        hd95s = [pv[name]["hd95"] for pv in per_vol
                 if np.isfinite(pv[name]["hd95"])]
        agg[name] = {"dice": float(np.mean(dices)),
                     "assd": float(np.mean(assds)) if assds else float("nan"),
                     "hd95": float(np.mean(hd95s)) if hd95s else float("nan"),
                     "assd_misses": int(sum(pv[name]["assd_miss"]
                                            for pv in per_vol))}
    agg["mean"] = {
        "dice": float(np.mean([agg[n]["dice"] for n in structures.values()])),
        "assd": float(np.nanmean([agg[n]["assd"]
                                  for n in structures.values()])),
        "hd95": float(np.nanmean([agg[n]["hd95"]
                                  for n in structures.values()])),
        "assd_misses": int(sum(agg[n]["assd_misses"]
                               for n in structures.values())),
    }
    return agg


def evaluate_volumes(forward: Callable, volumes: Sequence[np.ndarray],
                     labels: Sequence[np.ndarray], *, context: int = 3,
                     batch_size: int = 8, spacing=None,
                     structures: dict = STRUCTURES,
                     single_dispatch: bool = True,
                     postprocess: Callable | None = None, fwd_args=(),
                     device="cuda") -> dict:
    """Evaluate ``forward(images, *fwd_args) -> probs`` over volumes ->
    aggregated metric table.

    ``spacing``: None (voxel units), one [3] spacing for all volumes, or a
    per-volume sequence of spacings (mm-correct ASD).  ``postprocess``, a
    ``(pred_vol, structures) -> pred_vol`` filter, is applied to each
    predicted volume before its metrics; the unfiltered table is kept under
    ``agg["raw"]``.  ``agg["per_volume"]`` holds the per-structure metrics
    of each volume in input order.  ``single_dispatch`` as in
    ``inference.predict_volume``.
    """
    per_vol, per_vol_raw = [], []
    for i, (vol, lab) in enumerate(zip(volumes, labels)):
        sp = spacing
        if sp is not None and np.ndim(sp) > 1:
            sp = spacing[i]
        pred = inference.predict_volume(forward, vol, context=context,
                                        batch_size=batch_size,
                                        single_dispatch=single_dispatch,
                                        fwd_args=fwd_args, device=device)
        if postprocess is not None:
            per_vol_raw.append(_metrics_one(pred, lab, structures, sp))
            pred = postprocess(pred, structures)
        per_vol.append(_metrics_one(pred, lab, structures, sp))
    agg = _aggregate(per_vol, structures)
    if postprocess is not None:
        agg["raw"] = _aggregate(per_vol_raw, structures)
        agg["raw"]["per_volume"] = per_vol_raw
    agg["per_volume"] = per_vol
    return agg


_NON_STRUCTURE_KEYS = ("mean", "raw", "per_volume")


def format_table(agg: dict) -> str:
    """The paper's table: Dice (%), ASSD, HD95 and misses per structure."""
    names = [n for n in agg if n not in _NON_STRUCTURE_KEYS] + ["mean"]
    lines = [f"{'structure':>10} {'Dice':>8} {'ASSD':>8} {'HD95':>8} "
             f"{'miss':>5}"]
    for n in names:
        miss = agg[n].get("assd_misses", 0)
        hd = agg[n].get("hd95", float("nan"))
        lines.append(f"{n:>10} {agg[n]['dice'] * 100:8.1f} "
                     f"{agg[n]['assd']:8.2f} {hd:8.2f} {miss:5d}")
    return "\n".join(lines)
