"""Checkpoint save / restore / prune (counterpart of the npz path of
``mcmda_tpu/utils/checkpoint.py``).

A checkpoint is ``<dir>/step_XXXXXXXX.npz`` in the JAX package's flat key
layout (``weights.flatten_state``), so the JAX package restores the port's
checkpoints and the port resumes the JAX package's.  Orbax directories
(``step_XXXXXXXX/``, what the JAX package writes on one device) are read
with ``tensorstore`` (``utils/orbax_read.py``): ``restore`` and
``latest_step`` take them as the JAX package does, and ``prune`` never
deletes one.  Without ``tensorstore`` a directory raises, in ``restore``
and in ``latest_step`` when it is the newest step, so that a run never
starts from an older step, or from step 0, beside one it cannot read.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np

from mcmda_tpu_torch import weights
from mcmda_tpu_torch.parallel import multihost
from mcmda_tpu_torch.utils import orbax_read


def save(path: str, state: Any, step: int | None = None) -> str:
    """Write ``state`` as ``<path>/step_<step>.npz`` (or ``<path>.npz``
    without a step); returns the step path without its suffix, as the JAX
    package does.  The file appears atomically: a reader polling the
    directory never sees a half-written checkpoint.  In a process group
    only rank 0 writes: the state is replicated, so one file serves every
    rank."""
    if step is not None:
        path = os.path.join(path, f"step_{step:08d}")
    if not multihost.is_primary():
        return path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **weights.flatten_state(state))
    os.replace(tmp, path + ".npz")
    return path


def restore(path: str, like: Any) -> Any:
    """Restore a state with the structure, devices and dtypes of ``like``
    from the checkpoint at ``path``: an npz file (suffix optional) or an
    orbax directory."""
    return weights.unflatten_state(weights.read_checkpoint(path, like), like)


def _steps(ckpt_dir: str) -> list:
    return sorted(int(m.group(1)) for n in os.listdir(ckpt_dir)
                  if (m := re.match(r"step_(\d+)\.npz$", n)))


def prune(ckpt_dir: str, keep: int = 3, protect=(),
          newest: int | None = None) -> None:
    """Delete all but the newest ``keep`` checkpoints; steps in ``protect``
    (the selection's candidates) survive.  ``newest``, the step of a save
    started just before, counts toward the newest ``keep`` even if its file
    is not listed yet, as in the JAX package, whose saves are asynchronous
    (the port's are not).  In a process group only rank 0 deletes."""
    if not os.path.isdir(ckpt_dir) or keep <= 0 or \
            not multihost.is_primary():
        return
    steps = sorted(set(_steps(ckpt_dir))
                   | ({newest} if newest is not None else set()))
    for s in steps[:-keep]:
        path = os.path.join(ckpt_dir, f"step_{s:08d}.npz")
        if s not in protect and os.path.exists(path):
            os.remove(path)


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step with a checkpoint in ``ckpt_dir`` (None if none):
    an npz file or a ``step_N/`` orbax directory, as the JAX package counts
    them (an in-flight ``.orbax-checkpoint-tmp`` save is none).  Raises the
    reader's error (what the directory is, and the npz conversion to run in
    the JAX package) when the newest step is a directory that cannot be
    read here."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    orbax = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)$", n))
             and os.path.isdir(os.path.join(ckpt_dir, n))]
    if orbax and max(orbax) > (steps[-1] if steps else -1):
        orbax_read.require(os.path.join(ckpt_dir, f"step_{max(orbax):08d}"))
        return max(orbax)
    return steps[-1] if steps else None
