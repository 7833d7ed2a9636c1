"""Data parallelism on ``torch.distributed`` (counterpart of
``mcmda_tpu/parallel/``).

PyTorch's idiom: one process per device, one process group, explicit
collectives.  The state is replicated (every rank holds a full copy), each
rank feeds its own shard of the batch, and the steps make their math global
where the JAX package names ``axis_name``: sync-BN, the loss's global sums,
one all-reduce of the gradients per optimizer step (``parallel/dp.py``).
NCCL carries the collectives on a GPU, gloo on the CPU (or when asked)."""

from mcmda_tpu_torch.parallel import dp, mesh, multihost  # noqa: F401
