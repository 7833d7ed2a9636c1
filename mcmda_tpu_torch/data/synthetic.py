"""Synthetic MMWHS-like cardiac phantoms (numpy copy of
``mcmda_tpu/data/synthetic.py``, so that seeds give the same volumes in both
packages).

Four structures (AA, LAC, LVC, MYO -- MYO a shell around LVC) as ellipsoids
with per-domain intensity mappings, bias field and noise.  Class ids follow
the benchmark: 0=background, 1=AA, 2=LAC, 3=LVC, 4=MYO.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# domain -> per-class mean intensity (bg, AA, LAC, LVC, MYO); deliberately
# different orderings to create a real cross-modality appearance shift.
_DOMAIN_INTENSITY = {
    "mri": np.array([0.05, 0.85, 0.55, 0.70, 0.35], np.float32),
    "ct": np.array([0.10, 0.40, 0.80, 0.30, 0.65], np.float32),
}


def make_volume(rng: np.random.Generator, domain: str, depth: int = 24,
                size: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (image [S,H,W] f32 normalized-ish, labels [S,H,W] int32)."""
    zz, yy, xx = np.meshgrid(np.linspace(-1, 1, depth), np.linspace(-1, 1, size),
                             np.linspace(-1, 1, size), indexing="ij")
    labels = np.zeros((depth, size, size), np.int32)

    def ellipsoid(center, radii):
        c, r = np.asarray(center), np.asarray(radii)
        return ((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2 + \
            ((xx - c[2]) / r[2]) ** 2 <= 1.0

    j = lambda s: rng.uniform(-s, s)  # noqa: E731  per-volume anatomy jitter
    # LVC + MYO shell
    lvc_c = (j(0.15), -0.25 + j(0.1), j(0.1))
    lvc_r = (0.55 + j(0.1), 0.28 + j(0.05), 0.28 + j(0.05))
    myo = ellipsoid(lvc_c, tuple(r * 1.45 for r in lvc_r))
    lvc = ellipsoid(lvc_c, lvc_r)
    labels[myo] = 4
    labels[lvc] = 3
    # LAC
    lac = ellipsoid((j(0.15), 0.35 + j(0.1), -0.25 + j(0.1)),
                    (0.45 + j(0.1), 0.22 + j(0.05), 0.25 + j(0.05)))
    labels[lac & (labels == 0)] = 2
    # AA
    aa = ellipsoid((j(0.2), 0.3 + j(0.1), 0.45 + j(0.1)),
                   (0.5 + j(0.1), 0.16 + j(0.04), 0.16 + j(0.04)))
    labels[aa & (labels == 0)] = 1

    means = _DOMAIN_INTENSITY[domain]
    img = means[labels].astype(np.float32)
    # domain-specific corruption: smooth bias field + noise
    bias = np.sin(3.0 * xx + j(2)) * np.cos(2.0 * yy + j(2)) * (0.08 if domain == "mri" else 0.03)
    noise_scale = 0.06 if domain == "mri" else 0.04
    img = img + bias + rng.normal(0, noise_scale, img.shape).astype(np.float32)
    img = (img - img.mean()) / (img.std() + 1e-8)
    return img, labels
