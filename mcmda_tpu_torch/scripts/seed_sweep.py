"""Seed-robustness sweep for the adaptation benchmark, on the PyTorch port:
the twin of ``scripts/seed_sweep.py``, with its arguments and its artifact
schema.

Trains the source segmenter once, then runs the shipped adaptation recipe
over N seeds on the synthetic benchmark, tracking the full quality curve
per seed (a probe every ``--eval-every`` steps, by default the config's
``adapt.select_every``), and reports per seed:

  - final:    Dice of the end-of-run state (what a fixed-step recipe ships)
  - selected: Dice at the critic-equilibrium-selected checkpoint
  - selected_cr / selected_cr_ent / selected_cfg / selected_dual: Dice at
              the class-ratio picks (plain, the cr_ent reservoir, the
              config's own policy, live + EMA variants jointly)
  - oracle:   best Dice over all evaluated checkpoints (upper bound; uses
              target labels, for validation only)

plus the block-level EMA variants, flip TTA and the reservoir's soup /
ensemble candidates, and mean +/- spread aggregates over seeds.  The
output is rewritten after every seed; ``--first-seed`` with ``--merge``
resumes a sweep or adds seeds.  ``settings`` records the lengths that ran
(``source_steps``, ``adapt_steps``, ``eval_every``) and ``source_digest``,
a sha256 of the trained source state; ``--merge`` refuses a file whose
lengths, digest or ``no_adapt`` differ from this call's, so that rows of
different source runs are never pooled.  ``--save-source`` writes the
trained source state and ``--source-ckpt`` loads it instead of training,
for a sweep split over machines that keep no run directory.

Source training and the ``ev`` steps between two probes run as
``loop.scanned_step`` on the device-resident data, as the JAX script's
``lax.scan`` dispatches do: on a GPU a CUDA graph of one step replayed
``inner`` times per call (``drivers.pick_inner`` of the length, at most
50: the JAX script's 50 at the shipped lengths).  Where it differs from
the JAX script: the seeds are ``utils/prng.py``'s, so trajectories match
the JAX package's only in distribution; the probes (live, flip TTA and,
with ``adapt.dam_ema`` > 0, the in-state EMA) run on the device with one
small read-back each, each a CUDA graph on a GPU where the JAX script jits
it; the artifact also records the card, the precision pins and the
dispatch (``settings``).

Usage (one H100: a source run of 20,000 steps, about 20 minutes on the
graph, then about 10 minutes per mri2ct seed at the shipped lengths; see
PERF.md)::

    python -m mcmda_tpu_torch.scripts.seed_sweep --direction mri2ct \\
        --seeds 2 --set segmenter.train_fused=pallas \\
        --save-source <dir>/mri2ct_source.npz \\
        --out results/torch_h100/mri2ct_seed_sweep.json
    # a later call: more seeds on the same source state
    python -m mcmda_tpu_torch.scripts.seed_sweep --direction mri2ct \\
        --first-seed 2 --seeds 3 --merge --set segmenter.train_fused=pallas \\
        --source-ckpt <dir>/mri2ct_source.npz \\
        --out results/torch_h100/mri2ct_seed_sweep.json
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

from mcmda_tpu_torch import config as config_mod
from mcmda_tpu_torch.data import pipeline, synthetic, volumes as vio
from mcmda_tpu_torch.ops.metrics import class_counts
from mcmda_tpu_torch.train import adapt as adapt_mod, drivers, loop, \
    source as source_mod
from mcmda_tpu_torch import weights
from mcmda_tpu_torch.utils import checkpoint, cuda_graph, \
    device as device_mod, prng, tree

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# block-level EMA decay x optional critic-equilibrium gate tau
VARIANTS = {f"ema{d}" + (f"g{t}" if t else ""): (d, t)
            for d in (0.9, 0.95) for t in (None, 0.25, 0.2, 0.15)}


def _pair_map(fn, *pairs):
    """``fn`` leaf by leaf over (DAM params, target BN) pairs of trees."""
    return tuple(tree.tree_map(fn, *parts) for parts in zip(*pairs))


def _counts(preds, true_labels, num_classes):
    """(intersection[C], predicted count[C]) as f32: every row's prediction
    counts, a row whose label is -1 (padding) intersects nothing.  One-hot
    sums (``class_counts``) with no shape that depends on the data, so that
    a probe captures as a CUDA graph."""
    preds = preds.reshape(-1)
    hit = torch.where(preds == true_labels.reshape(-1), preds, -1)
    return (class_counts(hit, num_classes).float(),
            class_counts(preds, num_classes).float())


@torch.no_grad()
def source_digest(params, bn_state) -> str:
    """sha256 of the trained source state: the params' then the BN state's
    leaves in tree order, as little-endian f32 bytes, read back at once.
    Two sweeps whose rows may be pooled hold the same digest."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in
                      tree.leaves(params) + tree.leaves(bn_state)])
    flat = flat.cpu()
    return hashlib.sha256(flat.numpy().astype("<f4").tobytes()).hexdigest()


def merge_mismatch(prev: dict, current: dict) -> list:
    """The names of the keys of ``current`` (settings of this call, or
    ``no_adapt``) whose value in the artifact ``prev`` differs, each with
    both values: rows of sweeps that differ in any of them are never
    pooled."""
    got = {**prev.get("settings", {}), "no_adapt": prev.get("no_adapt")}
    return [f"{k} (file {got.get(k)!r}, this call {v!r})"
            for k, v in current.items() if got.get(k) != v]


@torch.no_grad()
def device_dice(state, vol_stacks, true_sums, true_labels, fwd,
                num_classes):
    """Per-structure Dice inputs + unsupervised signals on the device:
    forward -> argmax -> intersection and predicted class-voxel counts, and
    the mean prediction entropy over every row (padding included, as in the
    JAX script); nothing is read back.  ``vol_stacks`` [k,B,H,W,ctx],
    ``true_labels`` [k*B,H,W] with -1 on padding rows."""
    ent_total = torch.zeros((), device=vol_stacks.device)
    preds = []
    for xb in vol_stacks:
        probs = fwd(state, xb)
        p = torch.clamp(probs.float(), 1e-8, 1.0)
        ent_total = ent_total - (p * torch.log(p)).sum()
        preds.append(probs.argmax(-1))
    preds = torch.cat(preds)
    inter, psum = _counts(preds, true_labels, num_classes)
    return inter, psum, ent_total / preds.numel()


def _commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True,
                              cwd=ROOT).stdout.strip() or "unknown"
    except OSError:
        return "unknown"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--direction", default="ct2mri",
                   choices=["mri2ct", "ct2mri"])
    p.add_argument("--config", default=None)
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--volumes", type=int, default=5)
    p.add_argument("--depth", type=int, default=64)
    p.add_argument("--source-steps", type=int, default=None)
    p.add_argument("--adapt-steps", type=int, default=None)
    # probe / selection cadence: defaults to the config's select_every, so
    # a sweep of a pinned recipe probes at the recipe's cadence
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--set", action="append", metavar="K.EY=VAL",
                   help="config override, same syntax as the CLI")
    p.add_argument("--out", default=None)
    p.add_argument("--first-seed", type=int, default=0,
                   help="first seed index (resume/shard a sweep)")
    p.add_argument("--merge", action="store_true",
                   help="preload per-seed rows from an existing --out and "
                        "merge (resume after a crash / add seeds)")
    p.add_argument("--device", default="cuda")
    # a sweep split over several calls of a machine that keeps no run
    # directory: one call saves its trained source state, later ones load
    # it (the digest in ``settings`` shows it is the same state)
    p.add_argument("--save-source", default=None, metavar="NPZ",
                   help="write the trained source state (params, BN, step) "
                        "to this npz file")
    p.add_argument("--source-ckpt", default=None, metavar="NPZ",
                   help="load the source state from an npz file written by "
                        "--save-source instead of training it")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = device_mod.resolve(args.device, deterministic=True)
    cfg = config_mod.load_config(args.config or os.path.join(
        ROOT, "configs", f"{args.direction}.json"), args.set)
    if args.source_steps:
        cfg = dataclasses.replace(cfg, source=dataclasses.replace(
            cfg.source, steps=args.source_steps))
    if args.adapt_steps:
        cfg = dataclasses.replace(cfg, adapt=dataclasses.replace(
            cfg.adapt, steps=args.adapt_steps))
    size = cfg.data.slice_size
    src_dom, tgt_dom = (("mri", "ct") if args.direction == "mri2ct"
                        else ("ct", "mri"))
    sv, sl = synthetic.make_dataset(0, src_dom, args.volumes + 1,
                                    args.depth, size)
    tv, tl = synthetic.make_dataset(0, tgt_dom, args.volumes + 1,
                                    args.depth, size)
    src_vols, src_labs = sv[:-1], sl[:-1]
    tgt_train = tv[:-1]
    test_vol, test_lab = tv[-1], tl[-1]
    nc = cfg.data.num_classes

    path = args.out or os.path.join("results", "torch_h100",
                                    f"{args.direction}_seed_sweep.json")
    ev = args.eval_every or cfg.adapt.select_every or 250
    lengths = {"source_steps": cfg.source.steps,
               "adapt_steps": cfg.adapt.steps, "eval_every": ev}
    prev = None
    if args.merge and os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        if prev.get("direction") != args.direction or \
                prev.get("overrides", []) != list(args.set or []):
            raise SystemExit(f"[sweep] refuse to merge into {path}: "
                             "direction/overrides mismatch")
        differs = merge_mismatch(prev, lengths)
        if differs:  # refused before the source run
            raise SystemExit(f"[sweep] refuse to merge into {path}: "
                             + "; ".join(differs) + " differ")

    # ---- source training (once, device-resident steps) ----
    t0 = time.time()
    src_ds = vio.volumes_to_slices(src_vols, src_labs,
                                   context=cfg.data.context_slices,
                                   drop_empty=True)
    graph = drivers.dispatch(device) == "graph"
    inner_src = drivers.pick_inner(cfg.source.steps)
    if args.source_ckpt:
        params, bn_state = weights.restore_source(args.source_ckpt, cfg,
                                                  device)
        done = int(weights.read_checkpoint(args.source_ckpt)[".step"])
        if done != cfg.source.steps:
            raise SystemExit(f"[sweep] {args.source_ckpt} holds a source "
                             f"run of {done} steps, this call asks for "
                             f"{cfg.source.steps}")
        s_state = source_mod.SourceState(
            params, bn_state, None,
            torch.tensor(done, dtype=torch.int32, device=device))
        print(f"[sweep] source state loaded from {args.source_ckpt}",
              flush=True)
    else:
        print(f"[sweep] source training {cfg.source.steps} steps...",
              flush=True)
        s_state = source_mod.init_state(cfg.run.seed, cfg, device)
        s_step = loop.scanned_step(
            source_mod.make_train_step(cfg, sample_from_device=True),
            inner_src, graph=graph, donate=cfg.run.donate)
        s_state, _ = loop.run(
            s_step, s_state,
            itertools.repeat(pipeline.to_device_arrays(src_ds, nc, device)),
            cfg.source.steps, seed=cfg.run.seed, log_every=0,
            inner_steps=inner_src)
        print(f"[sweep] source done in {time.time() - t0:.0f}s", flush=True)
        if args.save_source:
            checkpoint.save(args.save_source.removesuffix(".npz"),
                            dataclasses.replace(s_state, opt_state=None))
    digest = source_digest(s_state.params, s_state.bn_state)
    print(f"[sweep] source digest {digest}", flush=True)

    # test volume as device-resident stacks + labels (-1 on padding rows)
    stacked = vio.stack_context(test_vol, cfg.data.context_slices)
    b = cfg.data.batch_size
    pad = (-stacked.shape[0]) % b
    if pad:
        stacked = np.concatenate([stacked,
                                  np.repeat(stacked[-1:], pad, 0)], 0)
    k = stacked.shape[0] // b
    vol_stacks = torch.from_numpy(np.ascontiguousarray(
        stacked.reshape((k, b) + stacked.shape[1:]), np.float32)).to(device)
    lab_pad = np.concatenate([test_lab, np.full((pad,) + test_lab.shape[1:],
                                                -1, test_lab.dtype)], 0) \
        if pad else test_lab
    true_labels = torch.from_numpy(lab_pad.astype(np.int64)).to(device)
    true_sums = class_counts(true_labels, nc).float()

    a_fwd = adapt_mod.adapted_forward(cfg)

    def fwd_tta(st, xb):
        p = a_fwd(st, xb)
        pf = a_fwd(st, xb.flip(2))
        return 0.5 * (p + pf.flip(2))

    def probe_with(fwd, use_avg=False):
        """The probe of one variant: a CUDA graph on a GPU (as the JAX
        script jits each), fed the state's eval weights."""
        def dice_vec(inputs):
            inter, psum, ment = device_dice(
                types.SimpleNamespace(**inputs), vol_stacks, true_sums,
                true_labels, fwd, nc)
            d = 2.0 * inter / torch.clamp_min(psum + true_sums, 1e-6)
            return torch.cat([d, psum / psum.sum(), ment[None]])

        run = cuda_graph.call(
            dice_vec, lambda inputs: fwd(types.SimpleNamespace(**inputs),
                                         vol_stacks[0]), device, graph)

        @torch.no_grad()
        def probe(state):
            """(dice[C], pred class fractions[C], mean entropy) on the
            eval volume, read back at once; dice needs labels (oracle),
            fractions / entropy do not."""
            host = run(adapt_mod.forward_inputs(state, use_avg)).cpu()
            return host[:nc].numpy(), host[nc:2 * nc].numpy(), \
                float(host[-1])
        return probe

    probe_of = probe_with(a_fwd)
    probe_tta = probe_with(fwd_tta)
    # the shipped per-step EMA (adapt.dam_ema > 0: state.avg_* folded in
    # the train step), probed as a variant of its own
    state_ema_on = cfg.adapt.dam_ema > 0.0
    if state_ema_on:
        probe_state_ema = probe_with(adapt_mod.adapted_forward(
            cfg, use_avg=True), use_avg=True)

    def mean_dice(d) -> float:
        return float(np.mean(d[1:]))  # classes 1..4 are the structures

    @torch.no_grad()
    def vol_probs(state):
        """The eval volume's softmax stack [k,B,H,W,C] (f32, on the
        device), summed over reservoir picks for prediction ensembling."""
        return torch.stack([a_fwd(state, xb).float() for xb in vol_stacks])

    def dice_of_probs(probs):
        inter, psum = _counts(probs.argmax(-1), true_labels, nc)
        return (2.0 * inter / torch.clamp_min(psum + true_sums, 1e-6)).cpu() \
            .numpy()

    # unsupervised reference: class-voxel fractions of the SOURCE labels
    src_fracs = adapt_mod.label_fractions(src_labs, nc)

    # source-only lower bound (through the un-adapted state)
    base_state = adapt_mod.init_state(1, cfg, s_state.params,
                                      s_state.bn_state)
    no_adapt = mean_dice(probe_of(base_state)[0])
    print(f"[sweep] no-adapt mean Dice: {no_adapt:.3f}", flush=True)
    del base_state
    if prev is not None:
        differs = merge_mismatch(prev, {"source_digest": digest,
                                        "no_adapt": round(no_adapt, 4)})
        if differs:
            raise SystemExit(f"[sweep] refuse to merge into {path}: "
                             + "; ".join(differs) + " differ")

    # ---- adaptation sweep ----
    tgt_ds = vio.volumes_to_slices(tgt_train, context=cfg.data.context_slices)
    device_data = {"src": pipeline.to_device_arrays(src_ds, device=device),
                   "tgt": pipeline.to_device_arrays(tgt_ds, device=device)}
    n_blocks = cfg.adapt.steps // ev
    inner_ad = drivers.pick_inner(ev)
    calls = ev // inner_ad
    a_step = loop.scanned_step(
        adapt_mod.make_adapt_step(cfg, sample_from_device=True), inner_ad,
        graph=graph, donate=cfg.run.donate)
    dispatch = {"graph": graph, "inner_source": inner_src,
                "inner_adapt": inner_ad, "donate": cfg.run.donate}
    print(f"[sweep] dispatch: {dispatch}", flush=True)

    def block(state, root, blk):
        """``ev`` adaptation steps, ``inner_ad`` per call, call c seeded
        from (root, c); metrics of the last step stay on the device."""
        metrics = {}
        for c in range(blk * calls, (blk + 1) * calls):
            state, metrics = a_step(state, device_data,
                                    prng.step_key(root, c))
        return state, metrics

    @torch.no_grad()
    def ema_update(ema, state, decay):
        return _pair_map(lambda e, n: decay * e + (1 - decay) * n, ema,
                         (state.dam_params, state.tgt_bn))

    def with_weights(state, dam, bn):
        return dataclasses.replace(state, dam_params=dam, tgt_bn=bn)

    def debiased(state, ema, w):
        return with_weights(state, *_pair_map(lambda a: a / w, ema))

    def stash_state(state, stashed):
        return with_weights(state, *_pair_map(lambda a: a.to(device),
                                              stashed))

    def host_copy(state):
        return _pair_map(lambda a: a.detach().cpu(),
                         (state.dam_params, state.tgt_bn))

    commit = _commit()
    card = device_mod.card() if device.type == "cuda" else None

    def agg(key, sub=None):
        v = np.asarray([r[key][sub] if sub else r[key] for r in rows],
                       np.float64)
        return {"mean": round(float(v.mean()), 4),
                "std": round(float(v.std()), 4),
                "min": round(float(v.min()), 4),
                "max": round(float(v.max()), 4)}

    def write_out():
        """(Re)write the output JSON from the rows so far: called after
        every seed, so a killed sweep loses at most the seed in flight and
        resumes with --merge --first-seed."""
        out = {"direction": args.direction, "seeds": len(rows),
               "commit": commit,
               "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
               "overrides": list(args.set or []),
               "card": card,
               "settings": {**device_mod.settings(), "dispatch": dispatch,
                            **lengths, "source_digest": digest},
               "no_adapt": round(no_adapt, 4),
               "final": agg("final"), "selected": agg("selected"),
               "selected_cr": agg("selected_cr"),
               "selected_dual": agg("selected_dual"),
               **({"selected_cr_ent": agg("selected_cr_ent")}
                  if rows and all("selected_cr_ent" in r for r in rows)
                  else {}),
               **({"selected_cfg": agg("selected_cfg")}
                  if rows and all("selected_cfg" in r for r in rows)
                  else {}),
               **({"selected_ship": agg("selected_ship"),
                   "state_ema_final": agg("state_ema_final")}
                  if rows and "selected_ship" in rows[0] else {}),
               "oracle": agg("oracle"),
               **{n: agg(n) for n in VARIANTS},
               **{f"{n}_best": agg(f"{n}_best") for n in VARIANTS},
               "tta_live": agg("tta", sub="live"),
               "src_fracs": [round(float(x), 5) for x in src_fracs],
               "per_seed": [{k: v for k, v in r.items() if k != "curve"}
                            for r in rows],
               "curves": {r["seed"]: r["curve"] for r in rows}}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(out, f, indent=1)
        os.replace(tmp, path)
        return out

    rows = []
    if prev is not None:
        todo = set(range(args.first_seed, args.first_seed + args.seeds))
        rows = [{**r, "curve": prev["curves"][str(r["seed"])]}
                for r in prev["per_seed"] if r["seed"] not in todo]
        print(f"[sweep] merged {len(rows)} existing seed rows from {path}")
    out = None
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        t0 = time.time()
        state = adapt_mod.init_state(seed + 2, cfg, s_state.params,
                                     s_state.bn_state)
        warm = adapt_mod.select_warmup(cfg)
        selector = adapt_mod.EquilibriumSelector(
            warmup_step=cfg.adapt.steps // 5)
        cr_sel = adapt_mod.ClassRatioSelector(src_fracs, warmup_step=warm)
        # one class-ratio selector over the live DAM and every EMA variant:
        # picks (step, variant) jointly
        cr_dual = adapt_mod.ClassRatioSelector(src_fracs, warmup_step=warm)
        cr_ship = adapt_mod.ClassRatioSelector(src_fracs, warmup_step=warm)
        dual_snapshot = ship_snapshot = None
        # the shipped cr_ent reservoir, live in the loop; its pick can move
        # to an earlier step on any tick, so its Dice is read from the curve
        cr_ent_sel = adapt_mod.ClassRatioSelector(
            src_fracs, warmup_step=warm, policy="cr_ent",
            topk=cfg.adapt.select_topk)
        # the config's own policy and smoothing window, live
        cr_cfg_sel = adapt_mod.ClassRatioSelector(
            src_fracs, warmup_step=warm, policy=cfg.adapt.select_policy,
            topk=cfg.adapt.select_topk,
            smooth_window=adapt_mod.smooth_window(cfg))
        # host copies of the reservoir's weights (as SelectionProbe keeps),
        # for the soup / ensemble candidates, and of the config policy's
        # keep set, for flip TTA at the config's pick
        res_stash: dict = {}
        cfg_stash: dict = {}
        # cr_ent ranked on flip-averaged fractions / entropy
        cr_ent_tta_sel = adapt_mod.ClassRatioSelector(
            src_fracs, warmup_step=warm, policy="cr_ent",
            topk=cfg.adapt.select_topk)
        # raw EMA trees start at zero; w is the accumulated weight
        zeros = _pair_map(torch.zeros_like, (state.dam_params, state.tgt_bn))
        emas = {name: [zeros, 0.0] for name in VARIANTS}
        curve, best_oracle, sel_snapshot = [], (0, -1.0), None
        cr_snapshot = None
        root = prng.root_key(1000 + seed)
        for blk in range(n_blocks):
            state, metrics = block(state, root, blk)
            step_i = (blk + 1) * ev
            d_live, fr_live, ent_live = probe_of(state)
            scalars = torch.stack([metrics["d_acc"].float(), metrics.get(
                "feat_div", torch.zeros((), device=device)).float()]).cpu()
            dmean = mean_dice(d_live)
            rec = {"step": step_i, "dice": round(dmean, 4),
                   "d_acc": round(float(scalars[0]), 4),
                   "feat_div": round(float(scalars[1]), 6),
                   "fracs": [round(float(x), 5) for x in fr_live],
                   "ent": round(ent_live, 5)}
            rec["eq"] = round(selector.update(step_i, rec), 4)
            rec["cr"] = round(cr_sel.update(step_i, rec["fracs"]), 4)
            for name, (dec, tau) in VARIANTS.items():
                if tau is None or rec["eq"] < tau:
                    emas[name][0] = ema_update(emas[name][0], state, dec)
                    emas[name][1] = dec * emas[name][1] + (1 - dec)
                w = emas[name][1]
                if w > 0:
                    d_e, fr_e, ent_e = probe_of(
                        debiased(state, emas[name][0], w))
                    rec[f"dice_{name}"] = round(mean_dice(d_e), 4)
                    rec[f"fracs_{name}"] = [round(float(x), 5) for x in fr_e]
                    rec[f"ent_{name}"] = round(ent_e, 5)
                else:
                    rec[f"dice_{name}"] = rec["dice"]
                    rec[f"fracs_{name}"] = rec["fracs"]
                    rec[f"ent_{name}"] = rec["ent"]
            if state_ema_on:
                d_se, fr_se, ent_se = probe_state_ema(state)
                rec["dice_state_ema"] = round(mean_dice(d_se), 4)
                rec["fracs_state_ema"] = [round(float(x), 5) for x in fr_se]
                rec["ent_state_ema"] = round(ent_se, 5)
            cr_ent_sel.update(step_i, rec["fracs"], ent=rec["ent"])
            cr_cfg_sel.update(step_i, rec["fracs"], ent=rec["ent"])
            d_tta, fr_tta, ent_tta = probe_tta(state)
            rec["dice_tta"] = round(mean_dice(d_tta), 4)
            cr_ent_tta_sel.update(step_i, [float(x) for x in fr_tta],
                                  ent=ent_tta)
            # stash / evict host weight copies for the live reservoir
            ks = cr_ent_sel.keep_steps()
            if (step_i, "live") in ks:
                res_stash[(step_i, "live")] = host_copy(state)
            for kk in list(res_stash):
                if kk not in ks:
                    del res_stash[kk]
            ks_cfg = cr_cfg_sel.keep_steps()
            if (step_i, "live") in ks_cfg:
                cfg_stash[(step_i, "live")] = res_stash.get(
                    (step_i, "live")) or host_copy(state)
            for kk in list(cfg_stash):
                if kk not in ks_cfg:
                    del cfg_stash[kk]
            cr_dual.update(step_i, rec["fracs"], variant="live")
            for name in VARIANTS:
                cr_dual.update(step_i, rec[f"fracs_{name}"], variant=name)
            if state_ema_on:
                # the production dual policy: live vs the in-state EMA only
                cr_ship.update(step_i, rec["fracs"], variant="live")
                cr_ship.update(step_i, rec["fracs_state_ema"],
                               variant="state_ema")
            curve.append(rec)
            if dmean > best_oracle[1]:
                best_oracle = (step_i, dmean)
            if selector.best_step == step_i:
                sel_snapshot = (step_i, dmean)
            if cr_sel.best_step == step_i:
                cr_snapshot = (step_i, dmean)
            if cr_dual.best_step == step_i:
                v = cr_dual.best_variant
                dual_snapshot = (
                    step_i, rec["dice" if v == "live" else f"dice_{v}"], v)
            if state_ema_on and cr_ship.best_step == step_i:
                v = cr_ship.best_variant
                ship_snapshot = (
                    step_i, rec["dice" if v == "live" else f"dice_{v}"], v)
        # flip TTA on the end-of-run states (live + each EMA variant)
        tta = {"live": round(mean_dice(probe_tta(state)[0]), 4)}
        for name in VARIANTS:
            w = emas[name][1]
            if w > 0:
                tta[name] = round(mean_dice(probe_tta(
                    debiased(state, emas[name][0], w))[0]), 4)
        final = curve[-1]["dice"]
        by_step = {c["step"]: c for c in curve}
        cr_cfg_sel.finalize()   # resolve the smoothing tail (no-op at w=1)
        cfg_snapshot = (
            (cr_cfg_sel.best_step, by_step[cr_cfg_sel.best_step]["dice"])
            if cr_cfg_sel.best_step is not None else None)
        cr_ent_snapshot = (
            (cr_ent_sel.best_step, by_step[cr_ent_sel.best_step]["dice"])
            if cr_ent_sel.best_step is not None else None)
        # ---- tracking-gap candidates over the stashed reservoir ----
        ranked = cr_ent_sel.ranked()
        gap = {}
        if ranked:
            def soup_state(m):
                trees = [res_stash[(c["step"], c["variant"])]
                         for c in ranked[:m]]
                return stash_state(state, _pair_map(
                    lambda *xs: torch.stack(xs).mean(0).to(xs[0].dtype),
                    *trees))

            for name, m in (("soup4", min(4, len(ranked))),
                            ("soup_all", len(ranked))):
                gap[name] = round(mean_dice(probe_of(soup_state(m))[0]), 4)
            # prediction ensemble (softmax average) over the top-4 picks
            probs = None
            for c in ranked[:4]:
                p = vol_probs(stash_state(
                    state, res_stash[(c["step"], c["variant"])]))
                probs = p if probs is None else probs + p
            gap["ens4"] = round(mean_dice(dice_of_probs(probs)), 4)
            del probs
            # flip TTA at the shipped pick
            sel_tree = res_stash.get((cr_ent_sel.best_step,
                                      cr_ent_sel.best_variant))
            if sel_tree is not None:
                gap["tta_sel"] = round(mean_dice(probe_tta(
                    stash_state(state, sel_tree))[0]), 4)
        # flip TTA at the config policy's pick
        if cr_cfg_sel.best_step is not None:
            cfg_tree = cfg_stash.get((cr_cfg_sel.best_step,
                                      cr_cfg_sel.best_variant))
            if cfg_tree is not None:
                gap["tta_cfg"] = round(mean_dice(probe_tta(
                    stash_state(state, cfg_tree))[0]), 4)
        # the TTA-ranked selection signal: plain and TTA Dice at its pick
        if cr_ent_tta_sel.best_step is not None:
            c = by_step[cr_ent_tta_sel.best_step]
            gap["sel_tta_signal"] = c["dice"]
            gap["sel_tta_signal_ttad"] = c["dice_tta"]
        steps = cfg.adapt.steps
        row = {"seed": seed, "final": final, "tta": tta, "gap": gap,
               "selected_cr_ent": cr_ent_snapshot[1] if cr_ent_snapshot
               else final,
               "selected_cr_ent_step": cr_ent_snapshot[0] if cr_ent_snapshot
               else steps,
               "selected_cfg": cfg_snapshot[1] if cfg_snapshot else final,
               "selected_cfg_step": cfg_snapshot[0] if cfg_snapshot
               else steps,
               "selected": sel_snapshot[1] if sel_snapshot else final,
               "selected_step": sel_snapshot[0] if sel_snapshot else steps,
               "selected_cr": cr_snapshot[1] if cr_snapshot else final,
               "selected_cr_step": cr_snapshot[0] if cr_snapshot else steps,
               "selected_dual": dual_snapshot[1] if dual_snapshot else final,
               "selected_dual_step": dual_snapshot[0] if dual_snapshot
               else steps,
               "selected_dual_variant": dual_snapshot[2] if dual_snapshot
               else "live",
               "oracle": best_oracle[1], "oracle_step": best_oracle[0],
               "curve": curve}
        if state_ema_on:
            row["selected_ship"] = ship_snapshot[1] if ship_snapshot \
                else final
            row["selected_ship_step"] = ship_snapshot[0] if ship_snapshot \
                else steps
            row["selected_ship_variant"] = ship_snapshot[2] \
                if ship_snapshot else "live"
            row["state_ema_final"] = curve[-1].get("dice_state_ema", final)
        for name in VARIANTS:
            row[name] = curve[-1][f"dice_{name}"]
            row[f"{name}_best"] = max(c[f"dice_{name}"] for c in curve)
        rows.append(row)
        print(f"[sweep] seed {seed}: final={final:.3f} "
              f"selected={row['selected']:.3f}@{row['selected_step']} "
              f"selected_cr={row['selected_cr']:.3f}"
              f"@{row['selected_cr_step']} "
              f"cr_ent={row['selected_cr_ent']:.3f}"
              f"@{row['selected_cr_ent_step']} "
              f"cfg={row['selected_cfg']:.3f}@{row['selected_cfg_step']} "
              f"dual={row['selected_dual']:.3f}"
              f"@{row['selected_dual_step']}"
              f"/{row['selected_dual_variant']} "
              f"oracle={row['oracle']:.3f}@{row['oracle_step']} "
              f"tta_live={tta['live']:.3f} "
              + " ".join(f"{n}={row[n]:.3f}" for n in VARIANTS)
              + f" ({time.time() - t0:.0f}s)", flush=True)
        rows.sort(key=lambda r: r["seed"])
        out = write_out()
        print(f"[sweep] wrote {path} ({len(rows)} seeds)", flush=True)

    if out is not None:
        print(json.dumps({k: out[k] for k in
                          ("no_adapt", "final", "selected", "selected_cr",
                           "selected_cr_ent", "selected_dual", "oracle")
                          if k in out}))
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
