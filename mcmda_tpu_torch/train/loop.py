"""Training loop (counterpart of ``mcmda_tpu/train/loop.py``): step
dispatch, deferred metric logging, periodic checkpoints + prune,
restart-from-latest and a SIGTERM/SIGINT guard.  One train step per loop
iteration: the JAX package's ``scanned_step`` fuses dispatches for a TPU and
has no counterpart here."""

from __future__ import annotations

import os
import signal
from typing import Callable, Iterator

from mcmda_tpu_torch.utils import checkpoint, logging as mlog, prng


class _PreemptionGuard:
    """SIGTERM/SIGINT-aware flag so a preempted run checkpoints before
    dying."""

    def __init__(self):
        self.fired = False
        self._prev = {}

    def __enter__(self):
        def handler(signum, frame):
            self.fired = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False


def run(step_fn: Callable, state, batches: Iterator, num_steps: int, *,
        seed: int = 0, log_every: int = 50, ckpt_every: int = 0,
        ckpt_dir: str | None = None, logger: mlog.MetricsLogger | None = None,
        start_step: int = 0, callback: Callable | None = None,
        keep_checkpoints: int = 3):
    """Drive ``step_fn(state, batch, seed)`` from ``start_step`` to
    ``num_steps``.

    The seed of each step derives from (run seed, step), so a resumed run
    replays the same randomness from its restart point.  A log tick's
    metrics are read back one tick later (flushed on every exit path), so
    the host does not wait on the step it just queued.
    ``callback(step, state, metrics)`` fires at every checkpoint interval
    with that step's metrics as floats.  Returns (state, last metrics)."""
    logger = logger or mlog.MetricsLogger(echo=False)
    root = prng.root_key(seed)
    last_metrics = {}
    pending_log = None

    def _flush_log():
        nonlocal pending_log, last_metrics
        if pending_log is None:
            return
        s, m = pending_log
        pending_log = None
        last_metrics = {k: float(v) for k, v in m.items()}
        logger.log(s, last_metrics)

    with _PreemptionGuard() as guard:
        for step in range(start_step, num_steps):
            state, metrics = step_fn(state, next(batches),
                                     prng.step_key(root, step))
            if log_every and (step % log_every == 0
                              or step == num_steps - 1):
                _flush_log()
                pending_log = (step, metrics)
            if ckpt_every and step + 1 < num_steps and \
                    (step + 1) % ckpt_every == 0:
                if ckpt_dir:
                    checkpoint.save(ckpt_dir, state, step=step + 1)
                    checkpoint.prune(ckpt_dir, keep_checkpoints)
                if callback is not None:
                    callback(step + 1, state,
                             {k: float(v) for k, v in metrics.items()})
            if guard.fired:
                _flush_log()
                if ckpt_dir:
                    checkpoint.save(ckpt_dir, state, step=step + 1)
                    print(f"[loop] preemption signal: checkpointed at step "
                          f"{step + 1} and stopped", flush=True)
                return state, last_metrics
    _flush_log()
    if ckpt_dir:
        checkpoint.save(ckpt_dir, state, step=num_steps)
    return state, last_metrics


def maybe_resume(ckpt_dir: str | None, state):
    """Restart from the newest checkpoint in ``ckpt_dir``, if any ->
    (state, start step)."""
    if not ckpt_dir:
        return state, 0
    step = checkpoint.latest_step(ckpt_dir)
    if step is None:
        return state, 0
    return checkpoint.restore(os.path.join(ckpt_dir, f"step_{step:08d}"),
                              state), step
