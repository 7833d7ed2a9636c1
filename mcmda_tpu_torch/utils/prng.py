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


def fold_in(seed: int, data: int) -> int:
    """A seed mixed from ``seed`` and ``data`` (``jax.random.fold_in``):
    the data-parallel step folds each rank into its step's seed, so that no
    two ranks draw one stream."""
    words = np.random.SeedSequence([int(seed), int(data)]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def inner_key(seed: int, i: int, inner: int) -> int:
    """The seed of inner step ``i`` of a call that runs ``inner`` steps
    (``loop.scanned_step``): ``fold_in(seed, i)``, as the JAX package's
    ``scanned_step`` folds.  A one-step call keeps the call's seed, where
    JAX folds in 0 even then: a run at ``inner = 1`` is one step per call,
    as it was before steps were scanned, and draws what it drew then."""
    return seed if inner == 1 else fold_in(seed, i)


def generator(seed, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``.  A
    generator passes through as it is: a captured step draws from the
    generator registered with its CUDA graph, which the host re-seeds
    before each replay (``utils/cuda_graph.py``)."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(seed)
