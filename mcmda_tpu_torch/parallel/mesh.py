"""The data-parallel group (counterpart of ``mcmda_tpu/parallel/mesh.py``).

The JAX package's mesh is a 1-D array of devices that one process drives;
here it is the process group, one process per device (rank r on
``cuda:r``).  ``batch_sharding`` and ``replicated`` have no torch meaning: a
tensor lives on one device, each rank holds a full copy of the replicated
state and its own shard of the batch, so there is no layout to name.

The JAX package's fallback to its virtual CPU mesh is not ported: asking
for more ranks than there are CUDA devices on a ``cuda`` run raises, and
never continues on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mcmda_tpu_torch.parallel import multihost


def check_devices(num_ranks: int, device="cuda") -> None:
    """Raise when ``num_ranks`` ranks on ``device`` would need more CUDA
    devices than there are: one rank drives one device."""
    if torch.device(device).type == "cuda" and \
            num_ranks > torch.cuda.device_count():
        raise ValueError(
            f"data parallelism over {num_ranks} ranks: more ranks than "
            f"devices ({torch.cuda.device_count()} CUDA device(s) visible); "
            "one rank runs on one device")


def make_mesh(num_devices: int | None = None, device="cuda"):
    """The process group of ``num_devices`` ranks (all of them by default),
    each rank on one device.  Raises when a ``cuda`` run asks for more
    ranks than CUDA devices, and when the initialised group has another
    number of ranks: ``dp=N`` runs one process per rank, started by
    ``python -m mcmda_tpu_torch ... --dp N`` or by ``torchrun``."""
    world = multihost.world()[1]
    n = world if num_devices is None else num_devices
    check_devices(n, device)
    if world != n:
        raise ValueError(
            f"make_mesh({n}): the process group has {world} rank(s); "
            f"dp={n} runs one process per rank: start {n} (python -m "
            f"mcmda_tpu_torch ... --dp {n}, or torchrun --nproc-per-node "
            f"{n})")
    return dist.group.WORLD
