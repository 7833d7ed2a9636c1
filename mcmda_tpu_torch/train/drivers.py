"""Shared execution-strategy plumbing for the CLI and the library API
(counterpart of ``mcmda_tpu/train/drivers.py``, single-device half).

One place decides HOW a train step runs and HOW batches reach it: a host
sampler behind the double-buffered feed, or a device-resident dataset with
on-device sampling inside the step.  ``cli.py`` and ``api.py`` are thin
frontends over these helpers, so the command line and ``api.adapt(cfg,
...)`` execute identically.

Data parallelism (``dp > 1``, or an initialised ``torch.distributed`` world
of more than one process) needs the JAX package's ``parallel/`` modules,
which have no counterpart yet: until they do, every function here raises
``NotImplementedError`` for it and never runs on one device instead.  The JAX package's ``pick_inner`` and
``loop.scanned_step`` fuse dispatches for a TPU and have no counterpart.
"""

from __future__ import annotations

import torch.distributed as dist


def _world() -> tuple[int, int]:
    """(rank, world size) of the initialised process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def multihost_active() -> bool:
    return _world()[1] > 1


def is_primary() -> bool:
    return _world()[0] == 0


def _single_device_only(dp: int) -> None:
    if (dp and dp > 1) or multihost_active():
        raise NotImplementedError(
            f"data parallelism (dp={dp}, world size {_world()[1]}) needs "
            "parallel/dp, mesh and multihost, which are not ported yet; "
            "run with dp=0 on one device")


def feed(stream, device="cuda", prefetch: int = 2):
    from mcmda_tpu_torch.data import pipeline
    return pipeline.prefetch_to_device(stream, prefetch, device)


def host_seed(seed: int) -> int:
    """Per-host sampler seed: under multi-host each process must draw
    DIFFERENT batches (otherwise the assembled global batch is N copies of
    one host's draw and effective batch diversity silently drops N-fold)."""
    return seed + 100003 * _world()[0]


def feed_plumbing(cfg, dp: int = 0, device="cuda"):
    """(per-host batch size, feed transform): the input half of
    ``wrap_dp``, for callers that build their step separately (e.g. a
    pretrain and a main step over one shared sampler stream)."""
    _single_device_only(dp)
    return cfg.data.batch_size, lambda s: feed(s, device)


def wrap_dp(cfg, make_step, dp: int = 0, device="cuda", **mk_kwargs):
    """(step_fn, per-host batch size, feed transform): with ``dp`` 0 or 1
    the plain ``make_step(cfg, **mk_kwargs)`` fed by a host sampler through
    ``feed``."""
    _single_device_only(dp)
    return make_step(cfg, **mk_kwargs), cfg.data.batch_size, \
        lambda s: feed(s, device)


def device_resident_dp(cfg, make_step, dp: int, data_builder, **mk_kwargs):
    """(step_fn, data): the device-resident dataset ``data_builder(None)``
    (the argument is the batch sharding, None on one device) and the step
    that samples from it on the device.  The JAX package's ``inner``
    argument is the dispatch-fusion factor of its ``scanned_step`` and is
    dropped here: one train step per call."""
    _single_device_only(dp)
    data = data_builder(None)
    return make_step(cfg, sample_from_device=True, **mk_kwargs), data


def batch_sharding_for(dp: int = 0):
    """Batch sharding for feeding device-resident datasets: None on one
    device."""
    _single_device_only(dp)
    return None
