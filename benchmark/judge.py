"""The numbers that decide ``correct``, each a gap between what the
program produced and what the plain reference computes from the same
inputs.

Training, at the end of each of the check's calls of the program's step
object (steps that the CUDA graph replays, one call of one step and then
one of two; on the CPU one call per step), which expose the losses of a
call's last step and the state after it:

- ``loss1_gap``: the widest relative gap of the first step's losses that
  it computes before it updates anything (T2's critic loss, not its DAM
  loss, which follows the critic's update).
- ``loss_gap``: the same over every loss that the calls expose (after
  the first, the losses of a step that follows Adam's updates).  Adam's
  first update moves every weight by the rate whatever its gradient's
  size, so round-off flips the step of weights whose gradient is
  round-off small, and these losses spread more than the first; a step
  that trains on another batch than the reference's (a replay seeded
  wrong) moves them by far more.
- ``change_gap``: over the trained leaves, the gap between the program's
  and the reference's norm of the leaf's change since the start, after
  each call, over the reference's norm of that leaf or of the median
  leaf, whichever is larger; the worst leaf.  Leaves whose first
  gradient in the reference is under a thousandth of the median leaf's
  are left out: Adam moves them by round-off alone.
- ``mu_gap``: the same measure of Adam's first moment after the first
  step, (1 - beta1) times the gradient as the optimiser got it.

A cell's limits file names the numbers it compares; the others are
reported beside them.

Serving, over every pixel of every mask served: the gap by which the
float32 reference's probability of the served class lies below its best
(0 where the served class is the best; a near tie that bf16 breaks the
other way reads its small margin).  ``slice_gap`` is the worst slice's
mean of it; the widest pixel's and the share of pixels served another
class are reported beside it.
"""

from __future__ import annotations

import math
import statistics

EXCLUDE_BELOW = 1e-3


def gap(a: float, b: float, scale: float) -> float:
    """|a - b| / scale, infinite where either side is not finite."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(scale, 1e-30)


def _norm_gap(prog: dict, ref: dict, keep) -> float:
    """max over kept leaves |p - r| / max(r, median r)."""
    med = statistics.median(ref.values())
    return max((gap(prog[k], ref[k], max(ref[k], med))
                for k in ref if keep(k)), default=0.0)


def excluded_leaves(first_grads: dict) -> set:
    """Leaves (per tree) whose first gradient norm is under a thousandth
    of the median leaf's of their tree."""
    out = set()
    for tree, norms in first_grads.items():
        med = statistics.median(norms.values())
        out |= {(tree, k) for k, v in norms.items() if v < EXCLUDE_BELOW * med}
    return out


def train_readings(prog: dict, ref: dict, before_update=None) -> dict:
    """``prog`` and ``ref``: {"losses": [per step {name: value}],
    "change": [per step {tree: {leaf: norm}}], "mu": {tree: {leaf: norm}},
    and, in ``ref``, "first_grads": {tree: {leaf: norm}}}.
    ``before_update``: the losses that a step computes before it updates
    anything (``loss1_gap`` reads those of the first step; all by
    default)."""
    drop = excluded_leaves(ref["first_grads"])
    steps = [max(gap(lp[k], r, abs(r)) for k, r in lr.items())
             for lp, lr in zip(prog["losses"], ref["losses"], strict=True)]
    first = ref["losses"][0]
    loss1 = max(gap(prog["losses"][0][k], first[k], abs(first[k]))
                for k in (before_update or first))
    change_gap = 0.0
    for cp, cr in zip(prog["change"], ref["change"], strict=True):
        for tree, norms in cr.items():
            change_gap = max(change_gap, _norm_gap(
                cp[tree], norms, lambda k, t=tree: (t, k) not in drop))
    mu_gap = max(_norm_gap(prog["mu"][t], ref["mu"][t], lambda k: True)
                 for t in ref["mu"])
    return {"loss1_gap": loss1, "change_gap": change_gap,
            "mu_gap": mu_gap, "loss_gap": max(steps),
            "leaves_left_out": len(drop)}


def verdict(readings: dict, limits: dict):
    """(correct, [[name, value, limit], ...]) over the limits' names."""
    checks = [[k, float(readings[k]), float(limits[k])] for k in limits]
    return all(v <= lim for _, v, lim in checks), checks  # NaN fails
