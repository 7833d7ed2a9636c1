"""Checkpoint save / restore / prune (counterpart of the npz path of
``mcmda_tpu/utils/checkpoint.py``).

A checkpoint is ``<dir>/step_XXXXXXXX.npz`` in the JAX package's flat key
layout (``weights.flatten_state``), so the JAX package restores the port's
checkpoints and the port resumes the JAX package's.  Orbax directories
cannot be read without jax and raise (``weights.read_npz``).
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np

from mcmda_tpu_torch import weights


def save(path: str, state: Any, step: int | None = None) -> str:
    """Write ``state`` as ``<path>/step_<step>.npz`` (or ``<path>.npz``
    without a step); returns the step path without its suffix, as the JAX
    package does.  The file appears atomically: a reader polling the
    directory never sees a half-written checkpoint."""
    if step is not None:
        path = os.path.join(path, f"step_{step:08d}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **weights.flatten_state(state))
    os.replace(tmp, path + ".npz")
    return path


def restore(path: str, like: Any) -> Any:
    """Restore a state with the structure, devices and dtypes of ``like``
    from the npz checkpoint at ``path`` (suffix optional)."""
    return weights.unflatten_state(weights.read_npz(path), like)


def _steps(ckpt_dir: str) -> list:
    return sorted(int(m.group(1)) for n in os.listdir(ckpt_dir)
                  if (m := re.match(r"step_(\d+)\.npz$", n)))


def prune(ckpt_dir: str, keep: int = 3, protect=()) -> None:
    """Delete all but the newest ``keep`` checkpoints; steps in ``protect``
    survive."""
    if not os.path.isdir(ckpt_dir) or keep <= 0:
        return
    for s in _steps(ckpt_dir)[:-keep]:
        if s not in protect:
            os.remove(os.path.join(ckpt_dir, f"step_{s:08d}.npz"))


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step with a checkpoint in ``ckpt_dir`` (None if none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None
