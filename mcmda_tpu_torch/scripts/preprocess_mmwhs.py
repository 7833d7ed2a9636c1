"""Preprocess raw MMWHS volumes into the benchmark layout, on the port's
``data/volumes.py``: the twin of ``scripts/preprocess_mmwhs.py``, with the
same arguments and output.

Input: a directory of raw MMWHS files (e.g. mr_train_1001_image.nii.gz +
mr_train_1001_label.nii.gz, ct_train_*).  Output layout consumed by
``data/mmwhs.py``::

    <out>/<domain>/images/<name>.npz   (normalized f32 [S,H,W] + spacing)
    <out>/<domain>/labels/<name>.npz   (int8 benchmark class ids)

Label remapping: MMWHS uses intensity codes (500 LV blood, 205 myocardium,
420 LA blood, 820 ascending aorta, ...); the benchmark keeps 4 structures:
1=AA(820), 2=LAC(420), 3=LVC(500), 4=MYO(205), all else 0.

Usage: python -m mcmda_tpu_torch.scripts.preprocess_mmwhs --raw /data/raw \\
    --out /data/mmwhs
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np

from mcmda_tpu_torch.data import volumes as vio

MMWHS_TO_BENCH = {820: 1, 420: 2, 500: 3, 205: 4}


def remap_labels(lab: np.ndarray) -> np.ndarray:
    out = np.zeros_like(lab, dtype=np.int8)
    for raw, cid in MMWHS_TO_BENCH.items():
        out[lab == raw] = cid
    return out


def fit(vol: np.ndarray, size: int) -> np.ndarray:
    """Centre-crop / zero-pad the rows and columns of [S,H,W] to size x
    size."""
    def fix(a, axis):
        n = a.shape[axis]
        if n > size:
            start = (n - size) // 2
            sl = [slice(None)] * 3
            sl[axis] = slice(start, start + size)
            return a[tuple(sl)]
        if n < size:
            pad = [(0, 0)] * 3
            pad[axis] = ((size - n) // 2, size - n - (size - n) // 2)
            return np.pad(a, pad)
        return a
    return fix(fix(vol, 1), 2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--size", type=int, default=256,
                    help="center-crop/pad slices to size x size")
    args = ap.parse_args(argv)

    pairs = []
    for img in sorted(glob.glob(os.path.join(args.raw, "*_image.nii*"))):
        lab = img.replace("_image", "_label")
        dom = "mri" if re.search(r"(^|/)mr", os.path.basename(img)) else "ct"
        pairs.append((dom, img, lab if os.path.exists(lab) else None))
    if not pairs:
        sys.exit(f"no *_image.nii* files under {args.raw}")

    for dom, img_path, lab_path in pairs:
        name = os.path.basename(img_path).split("_image")[0]
        vol, spacing = vio.load_volume_with_spacing(img_path)
        vol = fit(vio.normalize_volume(vol), args.size)
        os.makedirs(os.path.join(args.out, dom, "images"), exist_ok=True)
        np.savez_compressed(os.path.join(args.out, dom, "images",
                                         name + ".npz"),
                            image=vol.astype(np.float32), spacing=spacing)
        if lab_path:
            lab = vio.load_volume(lab_path)
            lab = fit(remap_labels(np.round(lab).astype(np.int32)), args.size)
            os.makedirs(os.path.join(args.out, dom, "labels"), exist_ok=True)
            np.savez_compressed(os.path.join(args.out, dom, "labels",
                                             name + ".npz"),
                                label=lab.astype(np.int8))
        print(f"{dom}/{name}: {vol.shape} spacing={spacing.round(2)}",
              flush=True)


if __name__ == "__main__":
    main()
