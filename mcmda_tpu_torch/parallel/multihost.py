"""Multi-process data parallelism (counterpart of
``mcmda_tpu/parallel/multihost.py``).

Every process runs the same program: ``initialize`` joins them in one
``torch.distributed`` process group, each process drives one device, and
each feeds only its own shard of the data (``shard_dataset``).  Inside the
step nothing changes: the collectives of ``parallel/dp.py`` run over NCCL
on a GPU and over gloo on the CPU (or when asked: two ranks that share one
GPU, which NCCL refuses).

``global_batch`` has no counterpart: JAX assembles one global array from
the processes' local shards, while here each rank's step takes its own
shard as it is and the collectives make the math global.

Artifact writes are gated to rank 0: ``utils/checkpoint.save`` and
``prune``, the metrics logger, and the CLI's snapshots and
``selection.json``.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from mcmda_tpu_torch.utils.tree import leaves, unflatten


def world() -> tuple[int, int]:
    """(rank, world size) of the initialised process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda") -> bool:
    """Join a multi-process world; returns True when it has more than one
    process.

    With no address, count or id it joins the world that ``torchrun``
    describes in ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` (the counterpart of the JAX package's pod
    auto-detection) and, where those are not set, joins nothing.  Else all
    three name it: ``host:port`` (or a ``tcp://`` URL) of rank 0.  The
    backend is NCCL for a ``cuda`` device and gloo for the CPU unless
    ``backend`` names one.  On a GPU the process's current device becomes
    ``local_device(device)``."""
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                             "MASTER_ADDR", "MASTER_PORT")):
            return False
        init, rank, size = "env://", int(os.environ["RANK"]), \
            int(os.environ["WORLD_SIZE"])
    elif any(v is None for v in given):
        raise ValueError("pass the coordinator address, the number of "
                         "processes and the process id together, or none "
                         "of them (torchrun's environment)")
    else:
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        rank, size = int(process_id), int(num_processes)
    kind = torch.device(device).type
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init, world_size=size,
                            rank=rank)
    if kind == "cuda":
        torch.cuda.set_device(local_device(device))
    return size > 1


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``device`` as given, except a bare ``cuda`` in a
    world of several ranks, which is ``cuda:<local rank>`` (``LOCAL_RANK``
    where ``torchrun`` sets it, else the rank modulo the visible devices:
    ranks that outnumber the GPUs share them, which only gloo allows)."""
    d = torch.device(device)
    rank, size = world()
    if d.type != "cuda" or d.index is not None or size == 1:
        return d
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else rank % max(1, torch.cuda.device_count()))


def is_primary() -> bool:
    """True on the one process that writes checkpoints and metrics."""
    return world()[0] == 0


def global_mesh():
    """The group of every rank of every process (one device each)."""
    return dist.group.WORLD


def host_shard_range(n: int) -> tuple[int, int]:
    """Contiguous [lo, hi) slice of ``range(n)`` this process should load:
    per-host input sharding, so each process reads only its part of the
    dataset."""
    p, k = world()
    per = n // k
    extra = n % k
    lo = p * per + min(p, extra)
    return lo, lo + per + (1 if p < extra else 0)


def shard_dataset(ds, n_total_devices: int):
    """Per-host input sharding of a deterministic-order SliceDataset: trim
    to a multiple of the global device count, then keep only this
    process's contiguous range.  Every process must pass the identical
    dataset."""
    n = (len(ds) // n_total_devices) * n_total_devices
    lo, hi = host_shard_range(n)
    return dataclasses.replace(
        ds, images=ds.images[lo:hi],
        labels=None if ds.labels is None else ds.labels[lo:hi],
        volume_ids=ds.volume_ids[lo:hi], slice_ids=ds.slice_ids[lo:hi])


def replicate(tree, group=None):
    """Rank 0's copy of a state on every rank of ``group``: one broadcast
    per (dtype, device) of the flattened tensors.  Returns new tensors; the
    input is not written."""
    ts = leaves(tree)
    new = [None] * len(ts)
    for key in dict.fromkeys((t.dtype, t.device) for t in ts):
        idx = [i for i, t in enumerate(ts) if (t.dtype, t.device) == key]
        flat = torch.cat([ts[i].detach().reshape(-1) for i in idx])
        dist.broadcast(flat, src=0, group=group)
        off = 0
        for i in idx:
            new[i] = flat[off:off + ts[i].numel()].view_as(ts[i])
            off += ts[i].numel()
    return unflatten(tree, new)


def ensure_replicated(tree, group=None):
    """The state as it is.  In JAX a state is either per-process host data
    or a global array, and this converts the first; here every rank's
    tensors are always its own full copy, kept equal by ``replicate`` at a
    run's first step and by identical updates after it."""
    return tree


def fetch_replicated(tree):
    """The state as host numpy arrays.  In JAX a replicated global array is
    read through one addressable shard; here every rank's tensors are its
    own full copy, so this is a plain copy to the host."""
    return unflatten(tree, [t.detach().cpu().numpy()
                            for t in leaves(tree)])
