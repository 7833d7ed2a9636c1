"""Data-parallel steps and the collectives they are built from
(counterpart of ``mcmda_tpu/parallel/dp.py``).

Each rank steps its own shard of the batch; the state is replicated.  The
steps take a process group ``group`` (None on one device) where the JAX
package takes ``axis_name``, and make their math global with three
collectives:

- ``global_sum``: an all-reduce sum in the forward and the identity in the
  backward (the loss's global sums of T1, the JAX ``psum``);
- ``global_mean``: an all-reduce mean in the forward and an all-reduce mean
  of the cotangent in the backward (BN's raw moments E[x], E[x^2], the JAX
  ``pmean``);
- ``reduce_grads``: one all-reduce of the flattened gradients per
  optimizer step, summed for T1 and averaged for T2.

With these a step computes the exact gradient of the whole batch, what one
device computes on it.  That is a divergence on purpose: the JAX package
runs its T1 step with ``check_vma=False``, so the transpose of each loss
``psum`` is a ``psum`` again, and after the gradient ``psum`` its T1
gradient is N times the single-device one on N shards (Adam divides the
scale away except through its eps).  Here the backward of a global sum is
the identity: each rank's backward gives its shard's part of the gradient
of the global loss, and the sum over ranks is that gradient.

A collective with ``group=None`` is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mcmda_tpu_torch.utils import prng, tree


def _all_reduce_sum(x, group):
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GlobalMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_sum(x, group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce_sum(g, ctx.group)
                / dist.get_world_size(ctx.group), None)


def global_sum(x, group=None):
    """Sum of ``x`` over the ranks of ``group``; the identity backward."""
    return x if group is None else _GlobalSum.apply(x, group)


def global_mean(x, group=None):
    """Mean of ``x`` over the ranks of ``group``; the backward averages the
    cotangent over the ranks, as the mean of equal shards' moments needs."""
    return x if group is None else _GlobalMean.apply(x, group)


def reduce_grads(grads, group=None, mean: bool = False):
    """A gradient tree summed (``mean=False``, T1) or averaged (T2) over the
    ranks of ``group``, as one all-reduce of the flattened tensors."""
    if group is None:
        return grads
    leaves = tree.leaves(grads)
    flat = torch.cat([g.reshape(-1) for g in leaves])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= dist.get_world_size(group)
    out, off = [], 0
    for g in leaves:
        out.append(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return tree.unflatten(grads, out)


def mean_metrics(metrics: dict, group=None) -> dict:
    """Scalar metrics averaged over the ranks of ``group`` (one
    all-reduce)."""
    if group is None or not metrics:
        return metrics
    keys = list(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in keys])
    vals = _all_reduce_sum(vals, group) / dist.get_world_size(group)
    return dict(zip(keys, vals.unbind()))


def data_parallel_step(step_fn, group):
    """Wrap ``step(state, batch, seed)`` built with ``group``: each rank
    folds its rank into the step's seed, so that ranks augment (and sample)
    differently, and the metrics are averaged over the ranks."""
    rank = dist.get_rank(group)

    def step(state, batch, seed: int):
        new_state, metrics = step_fn(state, batch, prng.fold_in(seed, rank))
        return new_state, mean_metrics(metrics, group)

    return step


def data_parallel_forward(fwd_fn, group):
    """Shard a forward ``(params..., image)`` over the batch axis: each rank
    runs its contiguous part of the batch and the outputs are gathered in
    rank order, so every rank returns the whole batch's.  The batch must
    divide by the number of ranks."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)

    def wrapped(*args):
        x = args[-1]
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not divide by the "
                             f"{n} ranks of the group")
        part = x.shape[0] // n
        y = fwd_fn(*args[:-1], x[rank * part:(rank + 1) * part]).contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts)

    return wrapped
