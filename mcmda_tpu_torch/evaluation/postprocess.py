"""3D post-processing of predicted label volumes (numpy/scipy copy of
``mcmda_tpu/evaluation/postprocess.py``).

Largest-connected-component (LCC) filtering: for each foreground structure,
keep only the largest 3D connected component of its predicted mask and
relabel the rest background.  Cardiac structures are single connected
objects, so any secondary component is a false-positive island.  Runs on
the host once per volume, after the device inference.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def largest_component(mask: np.ndarray, connectivity: int = 3) -> np.ndarray:
    """Largest 3D connected component of a binary mask (empty-safe).

    ``connectivity``: scipy order — 1 = faces (6-neighborhood), 3 = faces +
    edges + corners (26-neighborhood, the lineage's default: a diagonal-only
    bridge should not split a structure in two).
    """
    structure = ndimage.generate_binary_structure(mask.ndim, connectivity)
    labeled, n = ndimage.label(mask, structure=structure)
    if n <= 1:
        return mask.astype(bool)
    sizes = ndimage.sum_labels(np.ones((), np.int64), labeled,
                               np.arange(1, n + 1))
    return labeled == (1 + int(np.argmax(sizes)))


def largest_components(pred_vol: np.ndarray, structures: dict,
                       connectivity: int = 3) -> np.ndarray:
    """Apply per-structure LCC filtering to an integer label volume.

    Voxels of a structure outside its largest component become background
    (0).  Classes not in ``structures`` (background) are untouched.
    """
    out = pred_vol.copy()
    for cid in structures:
        if cid == 0:
            continue
        m = pred_vol == cid
        if not m.any():
            continue
        keep = largest_component(m, connectivity)
        out[m & ~keep] = 0
    return out


def get(name: str):
    """Resolve a postprocess spec to a callable ``pred_vol -> pred_vol``.

    ``"none"``/``""``/None -> None; ``"cc"`` -> per-structure LCC.
    """
    if name in (None, "", "none"):
        return None
    if name == "cc":
        return largest_components
    raise ValueError(f"unknown postprocess {name!r} (expected 'none'|'cc')")
