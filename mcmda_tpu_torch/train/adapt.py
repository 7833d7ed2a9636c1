"""T2 + T3: PnP-AdaNet adversarial adaptation and unsupervised checkpoint
selection (counterpart of ``mcmda_tpu/train/adapt.py``).

One adapt step: on-device sampling (optional) -> one augmentation of the
concatenated source + target batch -> ``k_d`` critic steps -> ``k_g`` DAM
steps -> optional weight averaging.  Gradients are taken only with respect
to the DAM (the target domain adaptation module: the stages up to
``plug_depth``) and the critic; the frozen source path and the higher-layer
module (HLM) read ``src_params``, which never require a gradient, so their
convs compute input gradients only.  The state is functional: a step
returns a new ``AdaptState`` and never updates the old one in place.

``init_state`` copies the source checkpoint into both the frozen path and
the DAM (the K1 handoff).

Under data parallelism the step takes the process group ``group`` (the JAX
``axis_name``): sync-BN on every train-mode forward, the critic's and the
DAM's gradients averaged over the ranks (the GAN losses are per-shard
means of equal shards, so the mean is the whole batch's gradient), and the
critic accuracy averaged before the throttle decides, so that every rank
makes the same decision and feeds the same ``d_acc`` to the weight
average.

Selection: ``ClassRatioSelector``, ``EquilibriumSelector``,
``select_warmup``, ``smooth_window`` and ``label_fractions`` are host numpy,
copied from the JAX package (importing it would import jax);
``make_class_ratio_probe``, ``make_select_bundle`` and ``SelectionProbe``
run the probe on the device and read it back one tick later.
"""

from __future__ import annotations

import dataclasses
import json
import os
import types
import warnings
from typing import Any

import numpy as np
import torch

from mcmda_tpu_torch import weights
from mcmda_tpu_torch.config import ExperimentConfig
from mcmda_tpu_torch.data import pipeline
from mcmda_tpu_torch.models import critic as critic_mod
from mcmda_tpu_torch.models import segmenter
from mcmda_tpu_torch.ops import losses
from mcmda_tpu_torch.ops.metrics import class_counts
from mcmda_tpu_torch.parallel import dp
from mcmda_tpu_torch.train import drivers, optim
from mcmda_tpu_torch.utils import cuda_graph, prng, tree


@dataclasses.dataclass(frozen=True)
class AdaptState:
    src_params: Any      # frozen source segmenter (full tree)
    src_bn: Any          # frozen source running stats
    dam_params: Any      # trainable target DAM (stages <= plug_depth)
    tgt_bn: Any          # target-path BN state (its own running stats)
    critic_params: Any
    opt_g_state: Any
    opt_d_state: Any
    step: torch.Tensor   # int32 scalar
    # weight averaging (cfg.adapt.dam_ema > 0, else None): raw EMA trees
    # starting at zero, the accumulated EMA weight (``eval_weights`` divides
    # by it) and the smoothed critic-equilibrium distance gating the fold-in
    avg_dam: Any = None
    avg_bn: Any = None
    ema_w: Any = None
    eq_smooth: Any = None


def make_txs(cfg: ExperimentConfig):
    """(tx_g, tx_d): Adam for the DAM and the critic, the schedule over
    ``pretrain_steps + steps``."""
    a = cfg.adapt
    total = a.pretrain_steps + a.steps
    return (optim.Optimizer(a.lr_g, a.beta1, a.beta2, 0.0, a.lr_schedule,
                            total),
            optim.Optimizer(a.lr_d, a.beta1, a.beta2, 0.0, a.lr_schedule,
                            total))


def _copy(t):
    return tree.tree_map(lambda x: x.detach().clone(), t)


def init_state(seed: int, cfg: ExperimentConfig, src_params,
               src_bn) -> AdaptState:
    """Boot adaptation from a source checkpoint (K1 handoff): the source
    trees are copied into the frozen path, the DAM and the target BN; the
    critic is He-normal from a generator seeded with ``seed``."""
    device = tree.leaves(src_params)[0].device
    src_params, src_bn = _copy(src_params), _copy(src_bn)
    dam = segmenter.dam_init_from_source(src_params, cfg.segmenter,
                                         cfg.adapt.plug_depth)
    critic_params = critic_mod.init(cfg.critic, cfg.segmenter,
                                    generator=prng.generator(seed, device),
                                    device=device)
    tx_g, tx_d = make_txs(cfg)
    ema_on = cfg.adapt.dam_ema > 0.0

    def zeros(t):
        return tree.tree_map(torch.zeros_like, t) if ema_on else None

    return AdaptState(
        src_params=src_params, src_bn=src_bn, dam_params=dam,
        tgt_bn=_copy(src_bn), critic_params=critic_params,
        opt_g_state=tx_g.init(dam), opt_d_state=tx_d.init(critic_params),
        step=torch.zeros((), dtype=torch.int32, device=device),
        avg_dam=zeros(dam), avg_bn=zeros(src_bn),
        ema_w=torch.zeros((), device=device) if ema_on else None,
        # neutral prior: the gate stays closed until the minimax nears
        # equilibrium
        eq_smooth=torch.full((), 0.25, device=device) if ema_on else None)


def _with_grad(params):
    """(leaves that require grad, the tree built on them)."""
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    return leaves, tree.unflatten(params, leaves)


def _f32(taps):
    return {k: v.float() for k, v in taps.items()}


def make_adapt_step(cfg: ExperimentConfig, group=None, train_g: bool = True,
                    augment: bool = True, sample_from_device: bool = False):
    """Returns ``step(state, batch, seed) -> (state, metrics)``.

    batch = {"src_image": [B,H,W,C], "tgt_image": [B,H,W,C]} (no labels:
    the critic sees features only); with ``sample_from_device`` it is
    {"src": ..., "tgt": ...} of ``pipeline.to_device_arrays`` and the step
    draws its batches there.  ``seed`` seeds the step's generator (batch
    indices, then augmentation draws).  ``train_g=False`` is the critic
    pretrain phase.  Metrics are device scalars: d_loss, d_acc, feat_div,
    feat_mmd and, when the DAM trains, g_loss (feat_div and feat_mmd of
    this rank's shard).  ``group``: this rank's step of a data-parallel run
    (``parallel/dp.data_parallel_step`` wraps it)."""
    a = cfg.adapt
    seg_cfg = cfg.segmenter
    cr_cfg = cfg.critic
    tx_g, tx_d = make_txs(cfg)
    d_loss_fn, g_loss_fn = losses.gan_losses(a.gan_loss)
    boundary = losses.decision_boundary(a.gan_loss)
    bn_train_stages = (frozenset(segmenter.dam_stage_names(seg_cfg,
                                                           a.plug_depth))
                       if a.hlm_bn == "frozen" else None)
    # the frozen source path carries no gradient and only feeds the critic,
    # so it may run in bf16; the D-phase target view likewise
    src_seg_cfg = (dataclasses.replace(seg_cfg, compute_dtype="bfloat16")
                   if a.src_feats_bf16 else seg_cfg)
    d_seg_cfg = (dataclasses.replace(seg_cfg, compute_dtype="bfloat16")
                 if a.tgt_feats_bf16 else seg_cfg)
    # ONE target forward per step: the k_d critic steps never touch the
    # DAM, so the D-phase target features and the first G step's forward are
    # the same function at the same point.  The forward runs once with a
    # graph; the D phase reads it detached, the first G step backpropagates
    # through it.  share_tgt_fwd=false (or a bf16 D view) restores the
    # two-forward oracle.
    share_fwd = a.share_tgt_fwd and not a.tgt_feats_bf16

    def src_taps(state, x):
        # batch-statistic features; the new BN statistics are thrown away
        _, _, taps, _ = segmenter.apply(state.src_params, state.src_bn, x,
                                        src_seg_cfg, train=True, group=group)
        return _f32(taps)

    def tgt_forward(dam_params, state, x, cfg_fwd=seg_cfg):
        _, _, taps, new_bn = segmenter.apply(
            state.src_params, state.tgt_bn, x, cfg_fwd, train=True,
            dam_params=dam_params, plug_depth=a.plug_depth,
            bn_train_stages=bn_train_stages, group=group)
        return taps, new_bn

    def critic_logits(cp, taps):
        return critic_mod.flatten_logits(critic_mod.apply(cp, taps, cr_cfg))

    def d_step(state, f_src, f_tgt):
        leaves, cp = _with_grad(state.critic_params)
        with torch.enable_grad():
            if a.batch_critic:
                # one apply on [f_src; f_tgt]: per-sample math
                n = f_src[cr_cfg.taps[0]].shape[0]
                logits = critic_logits(cp, {t: torch.cat([f_src[t], f_tgt[t]])
                                            for t in cr_cfg.taps})
                l_s, l_t = logits[:n], logits[n:]
            else:
                l_s = critic_logits(cp, f_src)
                l_t = critic_logits(cp, f_tgt)
            dl = d_loss_fn(l_s, l_t, a.label_smooth)
            if a.r1_gamma > 0:
                # R1: the critic's gradient norm on real (source) features,
                # a double backward
                real = {t: f_src[t].detach().requires_grad_()
                        for t in cr_cfg.taps}
                gf = torch.autograd.grad(critic_logits(cp, real).sum(),
                                         list(real.values()),
                                         create_graph=True)
                n = f_src[cr_cfg.taps[0]].shape[0]
                r1 = sum(torch.square(g.float()).sum() for g in gf) / n
                dl = dl + 0.5 * a.r1_gamma * r1
            grads = tree.unflatten(state.critic_params,
                                   torch.autograd.grad(dl, leaves))
        grads = dp.reduce_grads(grads, group, mean=True)
        # the global accuracy: every rank makes the same throttle decision
        acc = dp.global_mean(
            losses.critic_accuracy(l_s.detach(), l_t.detach(), boundary),
            group)
        updates, new_opt = tx_d.update(grads, state.opt_d_state,
                                       state.critic_params)
        if a.d_acc_cap < 1.0:
            # throttle: while the critic is too far ahead the step is a true
            # no-op -- parameters, Adam moments and schedule count all held
            # -- decided on the device, with no host read
            gate = acc <= a.d_acc_cap
            updates = tree.tree_map(lambda u: u * gate.to(u.dtype), updates)
            new_opt = _where_opt(gate, new_opt, state.opt_d_state)
        new_critic = tree.tree_map(lambda p, u: p + u, state.critic_params,
                                   updates)
        # feature-space divergence between the source and target taps:
        # channel means (feat_div) and linear MMD^2 with phi = (x, x^2)
        fd = ft = 0.0
        for t in cr_cfg.taps:
            s32, t32 = f_src[t].float(), f_tgt[t].float()
            fd = fd + torch.square(s32.mean((0, 1, 2))
                                   - t32.mean((0, 1, 2))).mean()
            ft = ft + torch.square(torch.square(s32).mean((0, 1, 2))
                                   - torch.square(t32).mean((0, 1, 2))).mean()
        fd = fd / len(cr_cfg.taps)
        fmmd = fd + ft / len(cr_cfg.taps)
        return dataclasses.replace(state, critic_params=new_critic,
                                   opt_d_state=new_opt), \
            {"d_loss": dl.detach(), "d_acc": acc, "feat_div": fd,
             "feat_mmd": fmmd}

    def g_update(state, gl, grads, new_bn):
        grads = dp.reduce_grads(grads, group, mean=True)
        updates, new_opt = tx_g.update(grads, state.opt_g_state,
                                       state.dam_params)
        new_dam = tree.tree_map(lambda p, u: p + u, state.dam_params, updates)
        return dataclasses.replace(state, dam_params=new_dam,
                                   opt_g_state=new_opt, tgt_bn=new_bn), \
            {"g_loss": gl.detach()}

    def g_step(state, x_tgt):
        leaves, dam = _with_grad(state.dam_params)
        with torch.enable_grad():
            f_tgt, new_bn = tgt_forward(dam, state, x_tgt)
            gl = g_loss_fn(critic_logits(state.critic_params, f_tgt))
            grads = torch.autograd.grad(gl, leaves)
        return g_update(state, gl, tree.unflatten(state.dam_params, grads),
                        new_bn)

    def g_step_shared(state, f_tgt, leaves, new_bn):
        # the first G step off the shared forward: the GAN loss under the
        # POST-d_step critic, back through the saved DAM + HLM graph to the
        # DAM leaves only
        with torch.enable_grad():
            gl = g_loss_fn(critic_logits(state.critic_params, f_tgt))
            grads = torch.autograd.grad(gl, leaves)
        return g_update(state, gl, tree.unflatten(state.dam_params, grads),
                        new_bn)

    @torch.no_grad()
    def step(state: AdaptState, batch, seed: int):
        if sample_from_device:
            gen = prng.generator(seed, batch["src"]["images"].device)
            bs = cfg.data.batch_size
            x_s = pipeline.sample_device_batch(batch["src"], gen, bs)["image"]
            x_t = pipeline.sample_device_batch(batch["tgt"], gen, bs)["image"]
        else:
            x_s, x_t = batch["src_image"], batch["tgt_image"]
            gen = prng.generator(seed, x_s.device)
        if augment:
            # one augmentation of the concatenated batch per step; the D and
            # G phases share the augmented views
            both = pipeline.augment_images(gen, torch.cat([x_s, x_t]),
                                           cfg.data)
            x_s, x_t = both[:x_s.shape[0]], both[x_s.shape[0]:]
        metrics = {}
        leaves = new_bn = None
        if share_fwd and train_g and a.k_g > 0:
            leaves, dam = _with_grad(state.dam_params)
            with torch.enable_grad():
                f_tgt_g, new_bn = tgt_forward(dam, state, x_t)
            f_tgt = {k: v.detach().float() for k, v in f_tgt_g.items()}
        else:
            f_tgt = _f32(tgt_forward(state.dam_params, state, x_t,
                                     d_seg_cfg)[0])
        # the frozen source features are the same for every critic step
        f_src = src_taps(state, x_s)
        for _ in range(a.k_d):
            state, m = d_step(state, f_src, f_tgt)
            metrics.update(m)
        if train_g:
            if leaves is not None:
                state, m = g_step_shared(state, f_tgt_g, leaves, new_bn)
                metrics.update(m)
            for _ in range(a.k_g - (1 if leaves is not None else 0)):
                state, m = g_step(state, x_t)
                metrics.update(m)
            if a.dam_ema > 0.0:
                state = _fold_average(state, metrics["d_acc"], a)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step


def _where_opt(gate, new, old):
    """The optimizer state ``new`` where ``gate``, else ``old``, leaf by
    leaf (Adam's count, moments and the schedule count)."""
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(_where_opt(gate, n, o) for n, o in zip(new, old)))
    if isinstance(new, tuple):
        return tuple(_where_opt(gate, n, o) for n, o in zip(new, old))
    if isinstance(new, dict):
        return {k: _where_opt(gate, new[k], old[k]) for k in new}
    return torch.where(gate, new, old)


def _fold_average(state: AdaptState, d_acc, a) -> AdaptState:
    """Weight averaging over the minimax orbit: a raw EMA of the DAM and
    target BN, folded in only while the smoothed |d_acc - 0.5| is under
    ``ema_gate`` (0 disables the gate)."""
    dec, q = a.dam_ema, a.ema_gate_smooth
    eq = torch.abs(d_acc.float() - 0.5)
    eq_s = q * state.eq_smooth + (1 - q) * eq
    gate = ((eq_s < a.ema_gate).float() if a.ema_gate > 0
            else torch.ones_like(eq_s))

    def fold(e, n):
        return gate * (dec * e + (1 - dec) * n.to(e.dtype)) + (1 - gate) * e

    return dataclasses.replace(
        state,
        avg_dam=tree.tree_map(fold, state.avg_dam, state.dam_params),
        avg_bn=tree.tree_map(fold, state.avg_bn, state.tgt_bn),
        ema_w=(gate * (dec * state.ema_w + (1 - dec))
               + (1 - gate) * state.ema_w),
        eq_smooth=eq_s)


def eval_weights(state: AdaptState, use_avg: bool = False):
    """(dam_params, bn) to evaluate with: the live DAM, or the bias-corrected
    weight average (``weights.eval_weights``)."""
    return weights.eval_weights(
        {"dam_params": state.dam_params, "tgt_bn": state.tgt_bn,
         "avg_dam": state.avg_dam, "avg_bn": state.avg_bn,
         "ema_w": state.ema_w}, use_avg)


def adapted_forward(cfg: ExperimentConfig, use_avg: bool = False):
    """Eval-mode forward of the adapted net, ``(state, images) -> probs``:
    target DAM + frozen HLM, BN from the target running statistics.  The
    plain eval path, as the JAX package's probe and snapshots use."""
    def fwd(state: AdaptState, image):
        dam, bn = eval_weights(state, use_avg)
        return segmenter.apply(state.src_params, bn, image, cfg.segmenter,
                               dam_params=dam,
                               plug_depth=cfg.adapt.plug_depth)[1]
    return fwd


# ------------------------------------------------------------- selection
class _BestScoreSelector:
    """Track the checkpoint with the lowest score of an unsupervised signal
    (lower = better); persists the choice to ``selection.json``."""

    signal = "score"

    def __init__(self, warmup_step: int = 0):
        self.warmup_step = warmup_step
        self.best_step = None
        self.best_score = float("inf")
        # which weight variant scored best at best_step: "live" (the raw
        # DAM) or "avg" (the gated EMA); evaluation uses the same variant
        self.best_variant = "live"

    def _record(self, step: int, score: float,
                variant: str = "live") -> float:
        if step >= self.warmup_step and score < self.best_score:
            self.best_score = score
            self.best_step = step
            self.best_variant = variant
        return score

    def save(self, out_dir: str) -> None:
        if self.best_step is None:
            return
        with open(os.path.join(out_dir, "selection.json"), "w") as f:
            json.dump({"signal": self.signal,
                       "best_step": int(self.best_step),
                       "best_score": self.best_score,
                       "weights": self.best_variant}, f)


class EquilibriumSelector(_BestScoreSelector):
    """Selection by critic equilibrium: the EMA-smoothed |d_acc - 0.5|.
    The critic separates unadapted target features easily; as the DAM
    adapts d_acc falls toward chance, and a collapsing DAM separates easily
    again.  No target labels involved."""

    signal = "critic_equilibrium"

    def __init__(self, ema: float = 0.7, warmup_step: int = 0):
        super().__init__(warmup_step)
        self.ema = ema
        self.value = None

    def update(self, step: int, metrics) -> float:
        d = abs(float(metrics.get("d_acc", 0.5)) - 0.5)
        self.value = d if self.value is None else \
            self.ema * self.value + (1.0 - self.ema) * d
        return self._record(step, self.value)


class ClassRatioSelector(_BestScoreSelector):
    """Selection by the class-ratio prior: the L1 distance between the
    class-voxel fractions predicted on unlabeled target slices and the
    class fractions of the source labels.  A collapsing minimax shrinks or
    loses structures, which this distance sees directly.

    ``policy="cr_ent"`` keeps a reservoir of the ``topk`` lowest-distance
    candidates and picks by 2*rank(cr) + rank(entropy) within it;
    ``smooth_window`` w > 1 (odd) scores each tick by the centred w-tick
    boxcar mean of the raw streams, so a tick resolves w//2 ticks late (the
    tail at ``finalize``)."""

    signal = "class_ratio"

    def __init__(self, ref_fracs, warmup_step: int = 0,
                 policy: str = "cr", topk: int = 16,
                 smooth_window: int = 1):
        super().__init__(warmup_step)
        self.ref_fracs = np.asarray(ref_fracs, np.float64)
        self.policy = policy
        self.topk = max(1, topk)
        self.reservoir: list = []   # {step, variant, cr, ent}, lowest cr
        self.smooth_window = max(1, int(smooth_window))
        self._hist: dict = {}   # variant -> [(step, fracs, ent), ...]
        self._next: dict = {}   # variant -> first unresolved index

    def keep_steps(self):
        """Candidate (step, variant) pairs whose weights must stay stashed:
        the whole reservoir under cr_ent, just the best under cr, plus any
        tick still awaiting its smoothing window."""
        if self.policy == "cr_ent":
            keep = {(c["step"], c["variant"]) for c in self.reservoir}
        else:
            keep = ({(self.best_step, self.best_variant)}
                    if self.best_step is not None else set())
        for variant, hist in self._hist.items():
            for step, _fr, _ent in hist[self._next.get(variant, 0):]:
                keep.add((step, variant))
        return keep

    def ranked(self) -> list:
        """Reservoir candidates by 2*rank(cr) + rank(ent), best first."""
        if not self.reservoir:
            return []
        crs = np.asarray([c["cr"] for c in self.reservoir])
        ents = np.asarray([c["ent"] for c in self.reservoir])
        score = 2.0 * crs.argsort().argsort() + ents.argsort().argsort()
        return [self.reservoir[i]
                for i in np.argsort(score, kind="stable")]

    def _repick(self) -> None:
        order = self.ranked()
        if not order:
            return
        best = order[0]
        self.best_step = best["step"]
        self.best_score = best["cr"]
        self.best_variant = best["variant"]

    def _ingest(self, step: int, score: float, variant: str,
                ent: float | None) -> float:
        """Score one (possibly smoothed) tick into the pick machinery."""
        if self.policy != "cr_ent" or ent is None:
            if self.policy == "cr_ent":
                warnings.warn(
                    "ClassRatioSelector(policy='cr_ent') got ent=None; "
                    "falling back to plain class-ratio recording for this "
                    "update — selection quality may degrade", stacklevel=2)
            return self._record(step, score, variant)
        if step < self.warmup_step:
            return score
        self.reservoir.append({"step": step, "variant": variant,
                               "cr": score, "ent": float(ent)})
        self.reservoir.sort(key=lambda c: c["cr"])
        del self.reservoir[self.topk:]
        self._repick()
        return score

    def _resolve(self, variant: str, i: int, n_avail: int) -> None:
        """Feed history index ``i`` with its centred window mean (clipped
        to the ``n_avail`` ticks seen so far)."""
        h = self.smooth_window // 2
        win = self._hist[variant][max(0, i - h):min(n_avail, i + h + 1)]
        fr = np.mean([w[1] for w in win], axis=0)
        ents = [w[2] for w in win]
        ent = None if any(e is None for e in ents) else float(np.mean(ents))
        step = self._hist[variant][i][0]
        self._ingest(step, float(np.abs(fr - self.ref_fracs).sum()),
                     variant, ent)

    def update(self, step: int, pred_fracs, variant: str = "live",
               ent: float | None = None) -> float:
        fr = np.asarray(pred_fracs, np.float64)
        score = float(np.abs(fr - self.ref_fracs).sum())
        if self.smooth_window <= 1:
            return self._ingest(step, score, variant, ent)
        if step < self.warmup_step:
            # pre-warmup ticks stay out of the smoothing windows too
            return score
        hist = self._hist.setdefault(variant, [])
        hist.append((step, fr, None if ent is None else float(ent)))
        h = self.smooth_window // 2
        nxt = self._next.get(variant, 0)
        while nxt + h < len(hist):
            self._resolve(variant, nxt, len(hist))
            nxt += 1
        self._next[variant] = nxt
        return score

    def finalize(self) -> None:
        """Resolve the trailing ticks (shorter windows at the stream end);
        call once after the last update."""
        for variant, hist in self._hist.items():
            for i in range(self._next.get(variant, 0), len(hist)):
                self._resolve(variant, i, len(hist))
            self._next[variant] = len(hist)

    def save(self, out_dir: str) -> None:
        if self.best_step is None:
            return
        payload = {"signal": self.signal, "policy": self.policy,
                   "best_step": int(self.best_step),
                   "best_score": self.best_score,
                   "weights": self.best_variant}
        if self.smooth_window > 1:
            payload["smooth_window"] = self.smooth_window
        if self.policy == "cr_ent":
            payload["reservoir"] = [
                {"step": int(c["step"]), "variant": c["variant"],
                 "cr": c["cr"], "ent": c["ent"]} for c in self.reservoir]
        with open(os.path.join(out_dir, "selection.json"), "w") as f:
            json.dump(payload, f)


def select_warmup(cfg: ExperimentConfig) -> int:
    """Warmup step of the class-ratio selector: pretrain +
    ``adapt.select_warmup``, clamped to a fifth of the run so that short
    runs still select."""
    a = cfg.adapt
    return a.pretrain_steps + min(a.select_warmup, a.steps // 5)


def smooth_window(cfg: ExperimentConfig) -> int:
    """Smoothing window in ticks from ``adapt.select_smooth_span`` in steps:
    round(span / cadence), forced odd by rounding down, at least 1 (off)."""
    a = cfg.adapt
    ev = a.select_every or cfg.run.ckpt_every or 1
    w = int(round(a.select_smooth_span / max(1, ev)))
    if w % 2 == 0:
        w -= 1
    return max(1, w)


def label_fractions(labels, num_classes: int):
    """Class-voxel fractions of a set of label arrays (the source-domain
    prior of ``ClassRatioSelector``)."""
    counts = np.bincount(np.concatenate(
        [np.asarray(l).reshape(-1) for l in labels]).astype(np.int64),
        minlength=num_classes).astype(np.float64)
    return counts / counts.sum()


def forward_inputs(state, use_avg: bool = False) -> dict:
    """The fields of ``state`` that ``adapted_forward(cfg, use_avg)``
    reads (the others None): a probe's graph inputs.  The forward takes
    them back as a namespace (``types.SimpleNamespace(**inputs)``)."""
    avg = ("avg_dam", "avg_bn", "ema_w")
    return {name: getattr(state, name) if use_avg or name not in avg
            else None
            for name in ("src_params", "dam_params", "tgt_bn") + avg}


def make_class_ratio_probe(cfg: ExperimentConfig, probe_images,
                           use_avg: bool = False):
    """``state -> (predicted class fractions [C], mean prediction entropy)``
    as device tensors, over a fixed stack of unlabeled target slices
    ``probe_images`` [N,H,W,ctx], run batch by batch through the plain eval
    forward: one CUDA graph per tick on a GPU (the JAX package's jitted
    scan), whose inputs are the state's eval weights (``forward_inputs``;
    a donated train state's are read where they lie), eager on the CPU.
    The stack is padded to a multiple of the batch size by repeating its
    last slice; padding rows count toward neither the fractions nor the
    entropy."""
    fwd = adapted_forward(cfg, use_avg=use_avg)
    b = cfg.data.batch_size
    n = probe_images.shape[0]
    imgs = np.asarray(probe_images, np.float32)
    pad = (-n) % b
    if pad:
        imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)], 0)
    nc = cfg.data.num_classes
    runners: dict = {}

    def fractions(inputs, x):
        state = types.SimpleNamespace(**inputs)
        counts = torch.zeros(nc, dtype=torch.int64, device=x.device)
        ent_total = torch.zeros((), device=x.device)
        for i in range(0, x.shape[0], b):
            v = max(0, min(b, n - i))  # valid rows of this batch
            probs = fwd(state, x[i:i + b])
            p = torch.clamp(probs.float(), 1e-8, 1.0)
            ent = -(p * torch.log(p)).sum(-1)
            ent_total = ent_total + ent[:v].sum()
            counts += class_counts(probs[:v].argmax(-1), nc)
        counts = counts.float()
        n_valid = float(n * x.shape[1] * x.shape[2])
        return counts / counts.sum(), ent_total / n_valid

    @torch.no_grad()
    def probe(state: AdaptState):
        device = state.step.device
        if device not in runners:
            x = torch.from_numpy(imgs).to(device)
            runners[device] = cuda_graph.call(
                lambda inputs: fractions(inputs, x),
                lambda inputs: fwd(types.SimpleNamespace(**inputs), x[:b]),
                device, drivers.dispatch(device) == "graph")
        return runners[device](forward_inputs(state, use_avg))

    return probe


def make_select_bundle(cfg: ExperimentConfig, probe_images,
                       dual: bool = False):
    """Everything one selection tick needs, with no host read: the
    predicted class fractions and entropy of the live (and, when ``dual``,
    the EMA-average) weights, plus device copies of each variant's eval
    weights, the stash candidates.  Pair with ``SelectionProbe``, which
    reads the values one tick later."""
    probe_live = make_class_ratio_probe(cfg, probe_images)
    probe_avg = (make_class_ratio_probe(cfg, probe_images, use_avg=True)
                 if dual else None)

    @torch.no_grad()
    def bundle(state: AdaptState) -> dict:
        fracs, ent = probe_live(state)
        out = {"fracs_live": fracs, "ent_live": ent,
               "weights_live": tuple(map(_copy, eval_weights(state)))}
        if probe_avg is not None:
            out["fracs_avg"], out["ent_avg"] = probe_avg(state)
            out["weights_avg"] = tuple(map(_copy, eval_weights(state,
                                                               True)))
        return out

    return bundle


def _host(x):
    """A tree of tensors (or arrays) copied to the host."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return np.asarray(x)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class SelectionProbe:
    """Selection bookkeeping deferred by one tick (``loop.run(probe=)``).

    A call launches the device work of THIS tick (one ``bundle``) and reads
    back the PREVIOUS tick's results, so the training loop never waits on a
    probe.  ``flush()`` retires the pending tick; ``finalize()`` also
    resolves the selector's smoothing tail.  Selector updates, the stash of
    candidate weights (host copies) and selection.json writes happen at read
    time with the step each tick was probed at.  ``metrics`` may be device
    scalars; they are read at flush."""

    def __init__(self, bundle, primary, cr_selector,
                 eq_selector=None, logger=None, save_dir: str | None = None,
                 save_ok: bool = True):
        self._bundle = bundle
        self.primary = primary          # the selector driving best_step
        self._cr = cr_selector
        self._eq = eq_selector
        self._logger = logger
        self._save_dir = save_dir
        self._save_ok = save_ok
        self._pending = None
        self.best_stash: dict = {}
        # host copies of every candidate the selector still holds, keyed
        # (step, variant); dropped as candidates are evicted
        self._stash: dict = {}

    def __call__(self, step: int, state, metrics=None) -> None:
        out = self._bundle(state)       # queued on the device; no host read
        self.flush()
        d_acc = None if not metrics else metrics.get("d_acc")
        self._pending = (step, out, d_acc)

    def _keep(self):
        return (self._cr.keep_steps()
                if self.primary is self._cr and hasattr(self._cr,
                                                        "keep_steps")
                else set())

    def _point_best(self) -> bool:
        bk = (self.primary.best_step,
              getattr(self.primary, "best_variant", "live"))
        if bk in self._stash:
            dam, bn = self._stash[bk]
            self.best_stash["dam_params"] = dam
            self.best_stash["tgt_bn"] = bn
            return True
        return False

    def flush(self) -> None:
        """Read the pending tick (if any) and update all bookkeeping."""
        if self._pending is None:
            return
        step, out, d_acc = self._pending
        self._pending = None
        scalars = {}
        if self._eq is not None and d_acc is not None:
            scalars["equilibrium_dist"] = self._eq.update(
                step, {"d_acc": float(d_acc)})
        ent = float(out["ent_live"]) if "ent_live" in out else None
        scalars["class_ratio_dist"] = self._cr.update(
            step, _np(out["fracs_live"]), ent=ent)
        if ent is not None:
            scalars["probe_entropy"] = ent
        if "fracs_avg" in out:
            scalars["class_ratio_dist_avg"] = self._cr.update(
                step, _np(out["fracs_avg"]), variant="avg",
                ent=float(out["ent_avg"]) if "ent_avg" in out else None)
        if self._logger is not None:
            self._logger.log(step, scalars)
        # stash host copies of the candidates the cr selector still wants
        # (only a cr primary ever reads them), drop the evicted ones, then
        # point best_stash (mutated in place: callers hold it) at the pick
        ks = self._keep()
        for variant, wkey in (("live", "weights_live"),
                              ("avg", "weights_avg")):
            if wkey in out and (step, variant) in ks:
                self._stash[(step, variant)] = _host(out[wkey])
        for k in list(self._stash):
            if k not in ks:
                del self._stash[k]
        if not self._point_best() and self.primary.best_step == step:
            # a primary without a reservoir (EquilibriumSelector)
            avg = getattr(self.primary, "best_variant", "live") == "avg"
            dam, bn = out["weights_avg" if avg else "weights_live"]
            self.best_stash["dam_params"] = _host(dam)
            self.best_stash["tgt_bn"] = _host(bn)
        if self._save_dir and self._save_ok:
            self.primary.save(self._save_dir)

    def finalize(self) -> None:
        """Retire the last deferred tick and resolve the selector's
        smoothing tail (the pick may move onto one of the last w//2 ticks).
        Call once after the training loop."""
        self.flush()
        if not hasattr(self._cr, "finalize"):
            return
        self._cr.finalize()
        if self.primary is self._cr and hasattr(self._cr, "keep_steps"):
            ks = self._cr.keep_steps()
            for k in list(self._stash):
                if k not in ks:
                    del self._stash[k]
        self._point_best()
        if self._save_dir and self._save_ok:
            self.primary.save(self._save_dir)

    def protect_steps(self):
        """The steps prune must keep (``loop.run(protect_steps=)``)."""
        if hasattr(self.primary, "keep_steps"):
            return {s for s, _v in self.primary.keep_steps()}
        return ({self.primary.best_step}
                if self.primary.best_step is not None else ())
