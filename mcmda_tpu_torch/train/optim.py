"""Adam / AdamW with optax semantics over dicts of tensors (counterpart of
``mcmda_tpu/train/optim.py``).

The optimizer state keeps optax's structure, so a checkpoint flattens to the
JAX package's keys: a tuple of per-transform states,
``(ScaleByAdamState(count, mu, nu), [EmptyState for the weight decay],
ScaleByScheduleState(count) or EmptyState)`` -> ``.opt_state[0].count``,
``.opt_state[0].mu[...]``, ``.opt_state[0].nu[...]`` and, under the cosine
schedule, ``.opt_state[1].count`` (``[2]`` for AdamW).

Update, per optax: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``,
bias-corrected by ``1 - b^(count+1)`` (computed in f32), ``u = mu_hat /
(sqrt(nu_hat) + eps)`` with eps = 1e-8 outside the root, ``+ wd * p`` for
AdamW, times ``-lr(t)``.  The cosine rate at step t (0-based) is
``lr * (1 + cos(pi * min(t, T) / T)) / 2``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from mcmda_tpu_torch.utils.tree import leaves, tree_map


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class EmptyState(NamedTuple):
    pass


def cosine_decay(lr: float, total_steps: int, step):
    """optax ``cosine_decay_schedule(lr, total_steps)`` at ``step`` (an int
    or an int tensor), as an f32 tensor."""
    t = torch.clamp(torch.as_tensor(step), max=total_steps).float()
    cos = 0.5 * (1.0 + torch.cos(math.pi * t / total_steps))
    return lr * cos


class Optimizer:
    """``init(params)`` -> state; ``update(grads, state, params)`` ->
    (updates, new state), to be added to the params (optax's contract)."""

    def __init__(self, lr: float, beta1: float = 0.9, beta2: float = 0.999,
                 weight_decay: float = 0.0, schedule: str = "constant",
                 total_steps: int = 0, eps: float = 1e-8):
        if schedule not in ("constant", "cosine"):
            raise ValueError(f"unknown lr schedule {schedule!r}")
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.weight_decay = weight_decay
        self.cosine = schedule == "cosine" and total_steps > 0
        self.total_steps = total_steps

    def init(self, params):
        dev = leaves(params)[0].device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        states = [ScaleByAdamState(
            count=zero.clone(), mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))]
        if self.weight_decay > 0:
            states.append(EmptyState())
        states.append(ScaleByScheduleState(count=zero.clone())
                      if self.cosine else EmptyState())
        return tuple(states)

    @torch.no_grad()
    def update(self, grads, state, params):
        adam = state[0]
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, adam.mu)
        nu = tree_map(lambda g, v: (1 - b2) * torch.square(g) + b2 * v,
                      grads, adam.nu)
        count = adam.count + 1
        c = count.float()
        bc1 = 1 - torch.full_like(c, b1) ** c
        bc2 = 1 - torch.full_like(c, b2) ** c
        upd = tree_map(
            lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + self.eps), mu, nu)
        if self.weight_decay > 0:
            upd = tree_map(lambda u, p: u + self.weight_decay * p, upd,
                           params)
        sched = state[-1]
        if self.cosine:
            step_size = -cosine_decay(self.lr, self.total_steps, sched.count)
            sched = ScaleByScheduleState(count=sched.count + 1)
        else:
            step_size = -self.lr
        upd = tree_map(lambda u: u * step_size, upd)
        new = [ScaleByAdamState(count=count, mu=mu, nu=nu), *state[1:-1],
               sched]
        return upd, tuple(new)

