"""Benchmark splits (copy of ``mcmda_tpu/data/splits.py``).

MMWHS 2017: 20 MRI volumes (labeled source) and 20 CT volumes (unpaired
target); the PnP-AdaNet benchmark uses all 20 source volumes for supervised
training and splits the target into 16 unlabeled training volumes + 4
held-out test volumes.  The reverse CT->MRI direction mirrors this.

Patient-level IDs below are positional (volume index 0..19 in the released
ordering); when real MMWHS data is mounted, map filenames to indices with
``resolve_files``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Sequence

NUM_SOURCE_VOLUMES = 20
TARGET_TRAIN_IDS = tuple(range(16))   # unlabeled adaptation stream
TARGET_TEST_IDS = (16, 17, 18, 19)    # 4-volume evaluation set

# benchmark structures: class id -> name (MMWHS cardiac substructures)
STRUCTURES = {1: "AA", 2: "LAC", 3: "LVC", 4: "MYO"}


@dataclass(frozen=True)
class Split:
    source_train: Sequence[int]
    target_train: Sequence[int]
    target_test: Sequence[int]


def benchmark_split(direction: str = "mri2ct") -> Split:
    """direction: "mri2ct" (headline) or "ct2mri"."""
    if direction not in ("mri2ct", "ct2mri"):
        raise ValueError(direction)
    return Split(source_train=tuple(range(NUM_SOURCE_VOLUMES)),
                 target_train=TARGET_TRAIN_IDS,
                 target_test=TARGET_TEST_IDS)


def file_key(path: str):
    """Stable ordering/pairing key for a volume file: the patient number
    embedded in the filename when present, else the basename itself --
    never the filesystem glob order."""
    name = path.rsplit("/", 1)[-1]
    nums = re.findall(r"\d+", name)
    return (0, int(nums[-1])) if nums else (1, name)


def resolve_files(paths: List[str]) -> List[str]:
    """Sort volume files by ``file_key`` so positional split ids are stable
    across filesystems."""
    return sorted(paths, key=file_key)
