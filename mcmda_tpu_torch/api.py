"""High-level library API: the programmatic equivalent of the CLI
(counterpart of ``mcmda_tpu/api.py``).

For users who drive the framework from Python::

    import mcmda_tpu_torch.api as api
    cfg = api.load_config("configs/mri2ct.json")
    src = api.train_source(cfg, src_vols, src_labs, out_dir="runs/src")
    ad  = api.adapt(cfg, src, src_vols, src_labs, tgt_vols, out_dir="runs/ad")
    table = api.evaluate(cfg, ad, test_vols, test_labs)
    masks = api.predict(cfg, ad, new_vols)

``train_source`` runs on ``device`` (default ``"cuda"``; a missing GPU is an
error); the other calls run where the state they are given lives.  The CLI
builds its steps, feeds and eval forwards with the same helpers, so a seeded
CLI run and a seeded API run write the same checkpoints.

Data parallelism runs one process per device: ``train_source(..., dp=N)``
and ``adapt(..., dp=N)`` are called by each of the N ranks of an
initialised ``torch.distributed`` group (``python -m mcmda_tpu_torch ...
--dp N`` starts them, and so does ``torchrun``; ``parallel/multihost``
joins them).  In a world of several processes ``dp=0`` is data parallel
over all of them.  Every rank returns the same state; only rank 0 writes.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Sequence

import numpy as np
import torch

from mcmda_tpu_torch import config as config_mod
from mcmda_tpu_torch.config import ExperimentConfig
from mcmda_tpu_torch.data import pipeline, splits, volumes as vio
from mcmda_tpu_torch.evaluation import inference, postprocess as pp_mod, \
    report
from mcmda_tpu_torch.models import segmenter
from mcmda_tpu_torch.train import adapt as adapt_mod, drivers, loop, \
    source as source_mod
from mcmda_tpu_torch.utils import checkpoint as ckpt, device as device_mod, \
    logging as mlog, profiling, tree


def load_config(path: str | None = None) -> ExperimentConfig:
    return config_mod.load_config(path)


# Device-resident cutoff, shared with the CLI: datasets under 1 GiB live on
# the device and each step gathers its batch there (no host transfer per
# step); larger ones stream through a host sampler and the prefetching feed.
_ON_DEVICE_BYTES = 1 << 30


def _source_step_feed(cfg, ds, dp, device, n_steps: int):
    """(step, feed, device-resident?, inner) of ``n_steps`` of source
    training over the slice dataset ``ds`` (this rank's shard of it under
    data parallelism): the one place the cutoff picks the feed.  A
    device-resident step runs ``inner`` train steps per call
    (``drivers.pick_inner``, as the JAX package picks it); a host-sampler
    step one.  Prints the ``feed path:`` line."""
    ds = drivers.shard(ds, dp, device)
    on_device = ds.images.nbytes < _ON_DEVICE_BYTES
    if on_device:
        inner = drivers.pick_inner(n_steps, cfg.run.log_every,
                                   cfg.run.ckpt_every)
        step, device_data = drivers.device_resident_dp(
            cfg, source_mod.make_train_step, dp, inner,
            lambda _group: pipeline.to_device_arrays(
                ds, cfg.data.num_classes, device), device=device)
        feed = itertools.repeat(device_data)
    else:
        inner = 1
        step, global_batch, to_global = drivers.wrap_dp(
            cfg, source_mod.make_train_step, dp, device=device)
        sampler = iter(pipeline.BatchSampler(
            ds, global_batch, seed=drivers.host_seed(cfg.run.seed + 1),
            num_classes=cfg.data.num_classes))
        feed = to_global(sampler)
    print(drivers.feed_line(on_device, inner, dp, device), flush=True)
    return step, feed, on_device, inner


def train_source(cfg: ExperimentConfig, volumes: Sequence[np.ndarray],
                 labels: Sequence[np.ndarray], *, out_dir: str | None = None,
                 steps: int | None = None, dp: int = 0,
                 device="cuda") -> source_mod.SourceState:
    """Supervised source training.  Returns the trained state.  With
    ``out_dir`` it resumes from and checkpoints into that directory;
    without, it writes nothing.  ``dp`` > 1: data parallel over the ``dp``
    ranks of the process group (see the module docstring)."""
    device = device_mod.resolve(device, deterministic=True)
    ds = vio.volumes_to_slices(volumes, labels,
                               context=cfg.data.context_slices,
                               drop_empty=True)
    state = source_mod.init_state(cfg.run.seed, cfg, device)
    state, start = loop.maybe_resume(out_dir, state)
    n_steps = steps or cfg.source.steps
    step, feed, _, inner = _source_step_feed(cfg, ds, dp, device, n_steps)
    logger = mlog.MetricsLogger(os.path.join(out_dir, "metrics.jsonl")
                                if out_dir else None, echo=False)
    state, _ = loop.run(step, state, feed, n_steps,
                        seed=cfg.run.seed, log_every=cfg.run.log_every,
                        ckpt_every=cfg.run.ckpt_every if out_dir else 0,
                        ckpt_dir=out_dir, logger=logger, start_step=start,
                        inner_steps=inner)
    logger.close()
    return state


def _probe_images(tgt_ds) -> np.ndarray:
    """The selection probe's input: up to 64 target slices spread evenly,
    fixed before any feed decision."""
    idx = np.linspace(0, len(tgt_ds) - 1, min(64, len(tgt_ds))).astype(int)
    return tgt_ds.images[idx]


def _class_ratio_selector(cfg, src_labels) -> adapt_mod.ClassRatioSelector:
    return adapt_mod.ClassRatioSelector(
        adapt_mod.label_fractions(src_labels, cfg.data.num_classes),
        warmup_step=adapt_mod.select_warmup(cfg),
        policy=cfg.adapt.select_policy, topk=cfg.adapt.select_topk,
        smooth_window=adapt_mod.smooth_window(cfg))


def _select_every(cfg, n_adapt: int) -> int:
    """The probe cadence: ``adapt.select_every`` (else the checkpoint
    cadence), at most a quarter of a short run."""
    return min(cfg.adapt.select_every or cfg.run.ckpt_every,
               max(1, n_adapt // 4))


def _adapt_step_feed(cfg, src_ds, tgt_ds, dp, device, n_pre: int,
                     n_adapt: int, sel_every: int):
    """(mk_step(**kw), make_feed(), device-resident?, inner) of
    adaptation: the pretrain and the main phase each make their step and
    their feed; on the host-sampler path both feeds draw from one pair of
    sampler streams.  A device-resident step runs ``inner`` train steps per
    call, ``drivers.pick_inner`` of the two phases' lengths and the
    cadences, as the JAX package picks it; a host-sampler step one.  Under
    data parallelism both datasets are this rank's shards.  Prints the
    ``feed path:`` line."""
    src_ds = drivers.shard(src_ds, dp, device)
    tgt_ds = drivers.shard(tgt_ds, dp, device)
    on_device = (src_ds.images.nbytes
                 + tgt_ds.images.nbytes) < _ON_DEVICE_BYTES
    inner = drivers.pick_inner(n_pre, n_adapt, cfg.run.log_every,
                               cfg.run.ckpt_every, sel_every) \
        if on_device else 1
    if on_device:
        device_data = {
            "src": pipeline.to_device_arrays(src_ds, device=device),
            "tgt": pipeline.to_device_arrays(tgt_ds, device=device)}

        def mk_step(**kw):
            return drivers.device_resident_dp(
                cfg, adapt_mod.make_adapt_step, dp, inner,
                lambda _group: device_data, device=device, **kw)[0]

        def make_feed():
            return itertools.repeat(device_data)
    else:
        def mk_step(**kw):
            return drivers.wrap_dp(cfg, adapt_mod.make_adapt_step, dp,
                                   device=device, **kw)[0]

        per_host, to_global = drivers.feed_plumbing(cfg, dp, device=device)
        s_it = iter(pipeline.BatchSampler(
            src_ds, per_host, seed=drivers.host_seed(cfg.run.seed + 3)))
        t_it = iter(pipeline.BatchSampler(
            tgt_ds, per_host, seed=drivers.host_seed(cfg.run.seed + 4)))

        def make_feed():
            pairs = ({"src_image": a["image"], "tgt_image": b["image"]}
                     for a, b in zip(s_it, t_it))
            return to_global(pairs)

    print(drivers.feed_line(on_device, inner, dp, device), flush=True)
    return mk_step, make_feed, on_device, inner


def _materialize_pick(out_dir, state, select_probe, selector) -> bool:
    """Write the selected step's checkpoint if it is not on disk: the final
    state with the stashed DAM / target BN of the pick (the frozen paths
    never change, and the optimizer state does not matter to evaluation).
    The stash holds the chosen weight variant, so ``ema_w`` is zeroed and a
    later average-weights evaluation falls back to exactly those weights.
    Only rank 0 writes."""
    stash, best = select_probe.best_stash, selector.best_step
    if not (out_dir and stash and best is not None
            and drivers.is_primary()):
        return False
    base = os.path.join(out_dir, f"step_{best:08d}")
    if os.path.isdir(base) or os.path.exists(base + ".npz"):
        return False
    sel_state = dataclasses.replace(
        state, dam_params=stash["dam_params"], tgt_bn=stash["tgt_bn"],
        step=torch.tensor(best, dtype=torch.int32))
    if sel_state.ema_w is not None:
        sel_state = dataclasses.replace(
            sel_state, ema_w=torch.zeros_like(sel_state.ema_w))
    ckpt.save(out_dir, sel_state, step=best)
    return True


def adapt(cfg: ExperimentConfig, source_state: source_mod.SourceState,
          src_volumes: Sequence[np.ndarray], src_labels,
          tgt_volumes: Sequence[np.ndarray], *, out_dir: str | None = None,
          steps: int | None = None, pretrain_steps: int | None = None,
          dp: int = 0) -> adapt_mod.AdaptState:
    """Critic pretrain, then PnP-AdaNet adaptation, on the device of
    ``source_state``.  With ``out_dir`` it resumes from and checkpoints into
    that directory, runs the class-ratio checkpoint selection
    (``selection.json``) and materializes the selected checkpoint; without,
    it writes nothing.  ``dp`` > 1: data parallel over the ``dp`` ranks of
    the process group; every rank runs the selection probe on the same
    state and target slices, so all make the same pick, and rank 0 writes
    it."""
    device = device_mod.resolve(tree.leaves(source_state.params)[0].device,
                                deterministic=True)
    src_ds = vio.volumes_to_slices(src_volumes, src_labels,
                                   context=cfg.data.context_slices,
                                   drop_empty=True)
    tgt_ds = vio.volumes_to_slices(tgt_volumes,
                                   context=cfg.data.context_slices)
    state = adapt_mod.init_state(cfg.run.seed + 2, cfg, source_state.params,
                                 source_state.bn_state)
    state, start = loop.maybe_resume(out_dir, state)
    logger = mlog.MetricsLogger(os.path.join(out_dir, "metrics.jsonl")
                                if out_dir else None, echo=False)
    n_pre = (pretrain_steps if pretrain_steps is not None
             else cfg.adapt.pretrain_steps)
    n_adapt = steps or cfg.adapt.steps
    probe_images = _probe_images(tgt_ds)
    sel_every = _select_every(cfg, n_adapt)
    mk_step, make_feed, _, inner = _adapt_step_feed(
        cfg, src_ds, tgt_ds, dp, device, n_pre, n_adapt, sel_every)

    if n_pre and start < n_pre:
        state, _ = loop.run(mk_step(train_g=False), state, make_feed(),
                            n_pre, seed=cfg.run.seed + 5,
                            log_every=cfg.run.log_every, logger=logger,
                            start_step=start, inner_steps=inner)
        start = n_pre
    # unsupervised checkpoint selection (class-ratio prior), the CLI's
    # machinery: scores the live DAM and, when weight averaging is on, the
    # EMA average, and selects the better
    selector = _class_ratio_selector(cfg, src_labels)
    select_probe = adapt_mod.SelectionProbe(
        adapt_mod.make_select_bundle(cfg, probe_images,
                                     dual=cfg.adapt.dam_ema > 0),
        primary=selector, cr_selector=selector, save_dir=out_dir,
        save_ok=drivers.is_primary())
    state, _ = loop.run(mk_step(), state, make_feed(), n_pre + n_adapt,
                        seed=cfg.run.seed + 6, log_every=cfg.run.log_every,
                        ckpt_every=cfg.run.ckpt_every if out_dir else 0,
                        ckpt_dir=out_dir, logger=logger, start_step=start,
                        inner_steps=inner,
                        probe_every=sel_every if out_dir else 0,
                        probe=select_probe if out_dir else None,
                        protect_steps=select_probe.protect_steps)
    select_probe.finalize()  # the last deferred tick + the smoothing tail
    _materialize_pick(out_dir, state, select_probe, selector)
    logger.close()
    return state


def _eval_forward(cfg: ExperimentConfig, params, bn, dam=None,
                  use_kernel: bool = True):
    """``images -> probs`` in eval mode under the eval view ``cfg``: the
    fused conv + BN + activation path under ``run.use_pallas`` (the
    hand-written kernel on a GPU; ``use_kernel=False`` runs its plain
    version), else the plain forward.  ``dam`` switches to the adapted net
    (target DAM + frozen higher layers)."""
    fwd = segmenter.apply
    kw = dict(dam_params=dam,
              plug_depth=cfg.adapt.plug_depth if dam is not None else None)
    if cfg.run.use_pallas:
        fwd = segmenter.apply_fused_eval
        kw["use_kernel"] = use_kernel
    return lambda img: fwd(params, bn, img, cfg.segmenter, **kw)[1]


def _forward_for(cfg: ExperimentConfig, state):
    """Eval forward for a source or adapted state (dispatch on type),
    shared by evaluate and predict.  Applies ``run.eval_bf16`` (serving-only
    precision) via ``config.eval_view``.  An adapted state serves its live
    DAM weights, as ``adapt.adapted_forward`` does by default."""
    cfg = config_mod.eval_view(cfg)
    if isinstance(state, adapt_mod.AdaptState):
        dam, bn = adapt_mod.eval_weights(state)
        return _eval_forward(cfg, state.src_params, bn, dam)
    return _eval_forward(cfg, state.params, state.bn_state)


def _serving(cfg, fwd, postprocess, tta):
    """(``fwd`` under the test-time augmentation, the postprocess filter
    or None): ``tta`` / ``postprocess`` by name, defaulting to
    ``run.eval_tta`` / ``run.eval_postprocess``."""
    wrap = inference.get_tta(tta if tta is not None else cfg.run.eval_tta)
    if wrap is not None:
        fwd = wrap(fwd)
    return fwd, pp_mod.get(postprocess if postprocess is not None
                           else cfg.run.eval_postprocess)


def predict(cfg: ExperimentConfig, state, volumes: Sequence[np.ndarray], *,
            postprocess: str | None = None,
            tta: str | None = None) -> list[np.ndarray]:
    """Serving: per-volume segmentation masks [S,H,W] uint8 (argmax labels)
    for unlabeled volumes, on the device of ``state``.

    ``postprocess`` / ``tta`` as in :func:`evaluate` (defaulting to
    ``cfg.run.eval_postprocess`` / ``cfg.run.eval_tta``).  Write results with
    ``mcmda_tpu_torch.data.volumes.save_volume`` or via the ``predict``
    CLI.

    Each volume is a host span ``predict.volume`` (``profiling.span``)
    holding ``predict_volume``'s spans, ``predict.postprocess`` where a
    filter is set and ``predict.cast``, the cast to uint8."""
    device = device_mod.resolve(state.step.device)
    fwd, pp = _serving(cfg, _forward_for(cfg, state), postprocess, tta)
    preds = []
    for vol in volumes:
        with profiling.span("predict.volume"):
            pred = inference.predict_volume(fwd, vol,
                                            context=cfg.data.context_slices,
                                            batch_size=cfg.data.batch_size,
                                            device=device)
            if pp is not None:
                with profiling.span("predict.postprocess"):
                    pred = pp(pred, splits.STRUCTURES)
            with profiling.span("predict.cast"):
                pred = pred.astype(np.uint8)
        preds.append(pred)
    return preds


def evaluate(cfg: ExperimentConfig, state, volumes: Sequence[np.ndarray],
             labels: Sequence[np.ndarray], *, spacing=None,
             postprocess: str | None = None, tta: str | None = None) -> dict:
    """3D-stitched Dice / ASSD / HD95 table for a source or adapted state
    (dispatches on the state type), on the device of ``state``.

    ``postprocess``: "none"/"cc", defaults to ``cfg.run.eval_postprocess``,
    exactly like ``evaluate`` on the CLI (the shipped benchmark configs set
    "cc", the largest-connected-component filter; the raw table is kept
    under the returned dict's ``"raw"`` key).

    ``tta``: "none"/"flip" test-time augmentation, defaults to
    ``cfg.run.eval_tta`` (flip averages probabilities over the horizontal
    flip, ``evaluation.inference.tta_flip``)."""
    device = device_mod.resolve(state.step.device)
    fwd, pp = _serving(cfg, _forward_for(cfg, state), postprocess, tta)
    return report.evaluate_volumes(fwd, volumes, labels,
                                   context=cfg.data.context_slices,
                                   batch_size=cfg.data.batch_size,
                                   spacing=spacing, postprocess=pp,
                                   device=device)
