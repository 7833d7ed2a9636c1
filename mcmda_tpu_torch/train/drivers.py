"""Shared execution-strategy plumbing for the CLI and the library API
(counterpart of ``mcmda_tpu/train/drivers.py``).

One place decides HOW a train step runs -- on one device, or data parallel
over the ranks of a ``torch.distributed`` process group -- and HOW batches
reach it: a host sampler behind the double-buffered feed, or a
device-resident dataset with on-device sampling inside the step.
``cli.py`` and ``api.py`` are thin frontends over these helpers, so
``--dp 2`` on the command line and ``api.adapt(cfg, ..., dp=2)`` on each of
two ranks execute identically.

Data parallel runs one process per device.  ``dp > 1`` asks for a group of
exactly ``dp`` ranks (``parallel/mesh.make_mesh``: more ranks than CUDA
devices on a ``cuda`` run, or an initialised world of another size,
raises); with ``dp`` 0 or 1 an initialised world of several processes
(``--multihost``) runs data parallel over all of them.  Each rank feeds its
own batch of ``data.batch_size`` (the global batch is ``dp`` times that),
drawn from its own shard of the dataset.

A device-resident step advances ``inner`` train steps per call
(``loop.scanned_step``, with ``inner`` from ``pick_inner``, as in the JAX
package); a host-sampler step one.  ``dispatch`` decides, before anything
is captured, how the steps run: on a CUDA device with no group or an NCCL
group, one step is captured as a CUDA graph and replayed (``inner`` times
per call on the device-resident data, once per fed batch on the host
sampler's: the counterparts of the JAX package's jitted steps); on the
CPU, or over a gloo group, whose collectives run on the host and cannot be
captured, the steps run eagerly.
"""

from __future__ import annotations

import math

import torch

from mcmda_tpu_torch.parallel import dp as dp_mod, mesh, multihost
from mcmda_tpu_torch.train import loop
from mcmda_tpu_torch.utils import cuda_graph


def multihost_active() -> bool:
    return multihost.world()[1] > 1


def is_primary() -> bool:
    return multihost.is_primary()


def dp_group(dp: int = 0, device="cuda"):
    """The process group a run is data parallel over, None on one device.
    Raises where ``dp > 1`` cannot be honoured; never runs on one device
    instead."""
    if dp and dp > 1:
        return mesh.make_mesh(dp, device)
    if multihost_active():
        return multihost.global_mesh()
    return None


def shard(ds, dp: int = 0, device="cuda"):
    """This rank's contiguous shard of a slice dataset under data
    parallelism (``multihost.shard_dataset``), else the dataset."""
    if dp_group(dp, device) is None:
        return ds
    return multihost.shard_dataset(ds, multihost.world()[1])


def feed(stream, device="cuda", prefetch: int = 2):
    from mcmda_tpu_torch.data import pipeline
    return pipeline.prefetch_to_device(stream, prefetch, device)


def host_seed(seed: int) -> int:
    """Per-rank sampler seed: under data parallelism each process must draw
    DIFFERENT batches (otherwise the global batch is N copies of one rank's
    draw and effective batch diversity silently drops N-fold)."""
    return seed + 100003 * multihost.world()[0]


def _replicating(step, group):
    """``step`` that first makes every rank start from rank 0's state
    (``multihost.replicate``, once: identical updates keep the ranks equal
    after it)."""
    first = [True]

    def wrapped(state, batch, seed):
        if first[0]:
            state, first[0] = multihost.replicate(state, group), False
        return step(state, batch, seed)

    return wrapped


def pick_inner(*counts, cap: int = 50) -> int:
    """Largest dispatch-fusion factor <= cap dividing every phase length and
    the logging grain (so scanned steps land exactly on boundaries)."""
    g = 0
    for c in counts:
        if c:
            g = math.gcd(g, c)
    if g <= 0:
        return 1
    for d in range(min(cap, g), 0, -1):
        if g % d == 0:
            return d
    return 1


def dispatch(device="cuda", group=None) -> str:
    """How a step (or a serving or probe call) runs: ``"graph"`` (a CUDA
    graph, replayed) on a CUDA device with no group or an NCCL group, else
    ``"eager"`` (the CPU has no graphs; gloo collectives run on the host
    and cannot be captured)."""
    if torch.device(device).type != "cuda":
        return "eager"
    if group is not None and \
            torch.distributed.get_backend(group) != "nccl":
        return "eager"
    return "graph"


def feed_line(on_device: bool, inner: int, dp: int = 0,
              device="cuda") -> str:
    """The ``feed path:`` line the CLI and the API print: the feed, and how
    many train steps a call runs and how."""
    group = dp_group(dp, device)
    feed_name = "device-resident" if on_device else "host-sampler"
    graph = dispatch(device, group) == "graph"
    if not on_device:
        how = ("one step per call on a CUDA graph" if graph
               else "one eager step per call")
    elif graph:
        how = f"{inner} steps per call on a CUDA graph"
    else:
        how = f"{inner} eager steps per call"
    sharded = " (per-rank sharded)" if group is not None else ""
    return f"feed path: {feed_name}{sharded}; {how}"


def _step(cfg, make_step, group, wrap=None, **mk_kwargs):
    step = (make_step(cfg, **mk_kwargs) if group is None
            else make_step(cfg, group=group, **mk_kwargs))
    if wrap is not None:
        step = wrap(step)
    if group is None:
        return step
    return _replicating(dp_mod.data_parallel_step(step, group), group)


def feed_plumbing(cfg, dp: int = 0, device="cuda"):
    """(per-rank batch size, feed transform): the input half of
    ``wrap_dp``, for callers that build their step separately (e.g. a
    pretrain and a main step over one shared sampler stream)."""
    dp_group(dp, device)
    return cfg.data.batch_size, lambda s: feed(s, device)


def wrap_dp(cfg, make_step, dp: int = 0, device="cuda", **mk_kwargs):
    """(step_fn, per-rank batch size, feed transform): ``make_step(cfg,
    **mk_kwargs)`` fed by a host sampler through ``feed``, one step per
    call: a CUDA graph of the step where ``dispatch`` says so
    (``cuda_graph.GraphedSteps`` with a fed batch, ``cfg.run.donate``),
    else the eager step; under data parallelism built with the group and
    wrapped by ``dp.data_parallel_step`` and ``_replicating``, whose
    broadcast of rank 0's state comes before the graph's capture."""
    group = dp_group(dp, device)
    return _step(cfg, make_step, group, wrap=_host_graph(cfg, device, group),
                 **mk_kwargs), cfg.data.batch_size, lambda s: feed(s, device)


def _host_graph(cfg, device, group):
    """The wrap of a host-sampler step: a fed CUDA graph of one step
    where ``dispatch`` says so, else None (the eager step)."""
    if dispatch(device, group) != "graph":
        return None
    return lambda step: cuda_graph.GraphedSteps(step, 1,
                                                donate=cfg.run.donate,
                                                fed=True)


def device_resident_dp(cfg, make_step, dp: int, inner: int, data_builder,
                       device="cuda", **mk_kwargs):
    """(step_fn, data): the device-resident dataset ``data_builder(group)``
    (the group is None on one device; under data parallelism the builder
    holds this rank's shard, see ``shard``) and the step that samples its
    batch from it on the device, ``inner`` train steps per call
    (``loop.scanned_step``: a CUDA graph where ``dispatch`` says so, with
    ``cfg.run.donate``).  Under data parallelism each rank folds its rank
    into the call's seed before the inner steps fold theirs, and the last
    step's metrics are averaged over the ranks, as in the JAX package."""
    group = dp_group(dp, device)
    data = data_builder(group)
    graph = dispatch(device, group) == "graph"

    def scan(step):
        return loop.scanned_step(step, inner, graph=graph,
                                 donate=cfg.run.donate)

    return _step(cfg, make_step, group, wrap=scan, sample_from_device=True,
                 **mk_kwargs), data


def batch_sharding_for(dp: int = 0, device="cuda"):
    """What a batch is split over: the data-parallel group (the JAX
    package's batch sharding of the mesh), None on one device."""
    return dp_group(dp, device)
