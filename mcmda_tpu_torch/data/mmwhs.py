"""Real-data loading for the MMWHS benchmark layout (copy of
``mcmda_tpu/data/mmwhs.py``).

Any mix of .nii/.nii.gz/.npz/.npy image+label volume pairs, matched by the
patient number in the filename.

Expected layout (configurable globs)::

    <root>/<domain>/images/*.nii.gz      (or .npz/.npy)
    <root>/<domain>/labels/*.nii.gz      (absent for unlabeled target train)

Volumes are normalized per volume and sliced with 3-adjacent-slice context
stacking.  Labels must already use the benchmark class ids
(0=bg, 1=AA, 2=LAC, 3=LVC, 4=MYO).
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from mcmda_tpu_torch.data import splits, volumes as vio


def _load_many(paths: List[str], normalize: bool) -> List[np.ndarray]:
    out = []
    for p in paths:
        v = vio.load_volume(p)
        out.append(vio.normalize_volume(v) if normalize else v)
    return out


def load_domain(root: str, domain: str, *, with_labels: bool = True,
                ids: Tuple[int, ...] | None = None):
    """Returns (volumes, labels_or_None) for a domain subdirectory."""
    img_paths = splits.resolve_files(
        sum((glob.glob(os.path.join(root, domain, "images", pat))
             for pat in ("*.nii", "*.nii.gz", "*.npz", "*.npy")), []))
    if not img_paths:
        raise FileNotFoundError(
            f"no volumes under {root}/{domain}/images (nii/npz/npy)")
    lab_paths = splits.resolve_files(
        sum((glob.glob(os.path.join(root, domain, "labels", pat))
             for pat in ("*.nii", "*.nii.gz", "*.npz", "*.npy")), []))
    if with_labels and lab_paths:
        # pairing is BY KEY (patient number / name), not by position: a
        # single missing or extra label file must fail loudly, not shift
        # every subsequent volume onto the wrong patient's labels
        img_keys = [splits.file_key(p) for p in img_paths]
        lab_keys = [splits.file_key(p) for p in lab_paths]
        if img_keys != lab_keys:
            only_img = [k for k in img_keys if k not in set(lab_keys)]
            only_lab = [k for k in lab_keys if k not in set(img_keys)]
            raise ValueError(
                f"{root}/{domain}: images and labels do not pair up "
                f"(keys only in images: {only_img[:5]}; only in labels: "
                f"{only_lab[:5]}) -- check for missing/extra/renamed files")
    if ids is not None:
        img_paths = [img_paths[i] for i in ids]
        lab_paths = [lab_paths[i] for i in ids] if lab_paths else []
    vols = _load_many(img_paths, normalize=True)
    labs = None
    if with_labels:
        if not lab_paths:
            raise FileNotFoundError(f"no labels under {root}/{domain}/labels")
        labs = [np.asarray(v, np.int32) for v in _load_many(lab_paths,
                                                            normalize=False)]
    return vols, labs


def load_benchmark(root: str, direction: str = "mri2ct"):
    """Full benchmark split: (src_vols, src_labs), tgt_train_vols,
    (tgt_test_vols, tgt_test_labs)."""
    src_dom, tgt_dom = (("mri", "ct") if direction == "mri2ct"
                        else ("ct", "mri"))
    sp = splits.benchmark_split(direction)
    src = load_domain(root, src_dom, with_labels=True, ids=sp.source_train)
    tgt_train, _ = load_domain(root, tgt_dom, with_labels=False,
                               ids=sp.target_train)
    tgt_test = load_domain(root, tgt_dom, with_labels=True,
                           ids=sp.target_test)
    return src, tgt_train, tgt_test
