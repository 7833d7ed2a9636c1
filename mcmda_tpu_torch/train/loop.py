"""Training loop (counterpart of ``mcmda_tpu/train/loop.py``): step
dispatch, deferred metric logging, periodic checkpoints + prune,
restart-from-latest and a SIGTERM/SIGINT guard.

``scanned_step`` advances ``inner_steps`` train steps per call, the JAX
package's ``lax.scan`` over a step: on a GPU one train step is captured as
a CUDA graph and replayed ``inner_steps`` times (``utils/cuda_graph.py``),
so the host issues a few calls per step instead of the step's thousands of
kernel launches; elsewhere the steps run one after another.  ``run``
drives such a step on the JAX package's schedule, in host spans
(``profiling.span``): ``train.call`` around each call of the step,
``train.log`` around a log tick's readback and write, ``train.probe``
around a probe tick and ``train.checkpoint`` around each save (with its
prune and callback)."""

from __future__ import annotations

import os
import signal
from typing import Callable, Iterator

from mcmda_tpu_torch.utils import checkpoint, logging as mlog, prng, profiling


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


def scanned_step(step_fn: Callable, inner_steps: int, *, graph: bool = False,
                 donate: bool = True) -> Callable:
    """``inner_steps`` consecutive train steps per call, with the
    ``(state, batch, seed)`` signature of ``step_fn``: inner step ``i``
    draws from the seed ``prng.fold_in(seed, i)`` (``prng.inner_key``: a
    one-step call keeps its seed), and the call returns the last inner
    step's metrics (fresh tensors, which the next call does not
    overwrite).  The batch must be loop-invariant: a device-resident dataset
    that the step samples from.

    ``graph``: one step is captured as a CUDA graph and replayed
    ``inner_steps`` times (``cuda_graph.GraphedSteps``; ``donate`` as
    there); otherwise the steps run eagerly, which draws the same numbers."""
    if graph:
        from mcmda_tpu_torch.utils import cuda_graph
        return cuda_graph.GraphedSteps(step_fn, inner_steps, donate=donate)

    def fused(state, batch, seed):
        metrics = {}
        for i in range(inner_steps):
            state, metrics = step_fn(state, batch,
                                     prng.inner_key(seed, i, inner_steps))
        return state, metrics

    return fused


def run(step_fn: Callable, state, batches: Iterator, num_steps: int, *,
        seed: int = 0, log_every: int = 50, ckpt_every: int = 0,
        ckpt_dir: str | None = None, logger: mlog.MetricsLogger | None = None,
        start_step: int = 0, callback: Callable | None = None,
        keep_checkpoints: int = 3, inner_steps: int = 1,
        protect_steps: Callable | None = None,
        probe_every: int = 0, probe: Callable | None = None):
    """Drive ``step_fn(state, batch, seed)`` from ``start_step`` to
    ``num_steps`` train steps.

    With ``inner_steps`` = k > 1, ``step_fn`` is a ``scanned_step``
    advancing k train steps per call; every count stays in train steps and
    the events fire after the call whose last step crosses their grain
    (``drivers.pick_inner`` makes k divide them all), as in the JAX
    package's loop.  The seed of each call derives from (run seed, call
    index), so a resumed run replays the same randomness from its restart
    point.  A log tick's metrics are read back one tick later (flushed on
    every exit path), so the host does not wait on the steps it just
    queued.  ``callback(step, state, metrics)`` fires at every checkpoint
    interval with that step's metrics as floats.  ``probe(step, state,
    metrics)`` fires every ``probe_every`` steps, a cadence of its own,
    with the metrics as device tensors (``adapt.SelectionProbe`` reads them
    one tick later).  Prune keeps the steps ``protect_steps()`` names.
    Returns (state, last metrics)."""
    logger = logger or mlog.MetricsLogger(echo=False)
    root = prng.root_key(seed)
    last_metrics = {}
    k = max(1, inner_steps)
    pending_log = None

    def _flush_log():
        nonlocal pending_log, last_metrics
        if pending_log is None:
            return
        s, m = pending_log
        pending_log = None
        with profiling.span("train.log"):
            last_metrics = {k: float(v) for k, v in m.items()}
            logger.log(s, last_metrics)

    with _PreemptionGuard() as guard:
        for outer in range(start_step // k, num_steps // k):
            step = (outer + 1) * k - 1  # the last train step of this call
            with profiling.span("train.call"):
                state, metrics = step_fn(state, next(batches),
                                         prng.step_key(root, outer))
            if log_every and (step % log_every < k or step >= num_steps - k):
                _flush_log()
                pending_log = (step, metrics)
            if probe is not None and probe_every and \
                    (step + 1) % probe_every < k:
                with profiling.span("train.probe"):
                    probe(step + 1, state, metrics)
            if ckpt_every and step + 1 < num_steps and \
                    (step + 1) % ckpt_every < k and \
                    (ckpt_dir or callback is not None):
                with profiling.span("train.checkpoint"):
                    if ckpt_dir:
                        checkpoint.save(ckpt_dir, state, step=step + 1)
                        checkpoint.prune(ckpt_dir, keep_checkpoints,
                                         protect=(protect_steps()
                                                  if protect_steps else ()),
                                         newest=step + 1)
                    if callback is not None:
                        callback(step + 1, state,
                                 {k: float(v) for k, v in metrics.items()})
            if guard.fired:
                _flush_log()
                if ckpt_dir:
                    with profiling.span("train.checkpoint"):
                        checkpoint.save(ckpt_dir, state, step=step + 1)
                    print(f"[loop] preemption signal: checkpointed at step "
                          f"{step + 1} and stopped", flush=True)
                return state, last_metrics
    _flush_log()
    if ckpt_dir:
        with profiling.span("train.checkpoint"):
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
