"""3D per-structure metrics -- Dice and (average) surface distances (copy of
``mcmda_tpu/evaluation/metrics3d.py``).

``dice`` and ``per_structure`` (Dice, ASSD, HD95) reimplement
medpy.metric.binary semantics natively on scipy's Euclidean distance
transform, so no medpy is needed: surface voxels are the binary object minus its erosion, distances
are sampled from the EDT of the other object's surface, with voxel spacing
honored.  Surface distances stay host-side.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def dice(pred: np.ndarray, truth: np.ndarray) -> float:
    """Hard Dice.  Empty-vs-empty returns 0.0 — medpy.metric.binary.dc's
    convention (it catches the 0/0 ZeroDivisionError and returns 0), kept
    exactly so tables are comparable to the benchmark lineage's medpy-based
    evaluations."""
    p = pred.astype(bool)
    t = truth.astype(bool)
    denom = p.sum() + t.sum()
    if denom == 0:
        return 0.0
    return float(2.0 * np.logical_and(p, t).sum() / denom)


def _surface(mask: np.ndarray) -> np.ndarray:
    mask = mask.astype(bool)
    if not mask.any():
        return mask
    eroded = ndimage.binary_erosion(mask, ndimage.generate_binary_structure(
        mask.ndim, 1))
    return mask & ~eroded


def surface_distances(pred: np.ndarray, truth: np.ndarray,
                      spacing=None) -> np.ndarray:
    """Directed distances from pred's surface voxels to truth's surface
    (medpy ``__surface_distances``)."""
    sp = _surface(pred)
    st = _surface(truth)
    if not sp.any() or not st.any():
        return np.array([np.inf])
    dt = ndimage.distance_transform_edt(~st, sampling=spacing)
    return dt[sp]


def _symmetric_distances(pred, truth, spacing=None) -> np.ndarray:
    return np.hstack([surface_distances(pred, truth, spacing),
                      surface_distances(truth, pred, spacing)])


def per_structure(pred_vol: np.ndarray, true_vol: np.ndarray,
                  structures: dict, spacing=None) -> dict:
    """{name: {"dice": d, "assd": a, "hd95": h}} for each class id in
    ``structures``."""
    out = {}
    for cid, name in structures.items():
        p = pred_vol == cid
        t = true_vol == cid
        if t.any():
            d = _symmetric_distances(p, t, spacing)  # 2 EDTs, both metrics
            a, h = float(d.mean()), float(np.percentile(d, 95))
        else:
            a = h = float("nan")
        out[name] = {"dice": dice(p, t), "assd": a, "hd95": h}
    return out
