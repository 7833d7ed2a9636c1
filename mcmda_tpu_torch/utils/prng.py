"""Per-run and per-step seeds (counterpart of ``mcmda_tpu/utils/prng.py``).

One root seed per run; ``step_key`` derives the seed of a step's
``torch.Generator`` from (root, purpose, step) without replaying a stream,
so any step's randomness is reproducible and a resumed run replays the same
draws from its restart point.  The numbers are not JAX's: threefry and
torch's generators never agree, so tests that compare the two packages
inject the drawn values instead.
"""

from __future__ import annotations

import numpy as np
import torch


def root_key(seed: int) -> int:
    return int(seed)


def step_key(root: int, step: int, purpose: int = 0) -> int:
    """A 63-bit seed mixed from (root, purpose, step)."""
    words = np.random.SeedSequence([root, purpose, int(step)]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)
