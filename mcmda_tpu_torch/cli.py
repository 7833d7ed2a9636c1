"""Command-line entry points: the ``train-source``, ``adapt``,
``evaluate`` and ``predict`` subcommands of the JAX package's CLI
(``mcmda_tpu/cli.py``), on PyTorch::

    python -m mcmda_tpu_torch train-source --config configs/mri2ct.json \\
        --synthetic --out runs/src --set segmenter.train_fused=pallas
    python -m mcmda_tpu_torch adapt --config configs/mri2ct.json \\
        --synthetic --source-ckpt runs/src --out runs/adapt
    python -m mcmda_tpu_torch evaluate --config configs/mri2ct.json \\
        --synthetic --ckpt runs/adapt --set run.use_pallas=true
    python -m mcmda_tpu_torch predict --config configs/mri2ct.json \\
        --ckpt runs/adapt --input vols/ --out preds/ --set run.use_pallas=true

``train-source`` and ``adapt`` write ``step_XXXXXXXX.npz`` checkpoints in
the JAX package's key layout.  ``--ckpt`` takes a run directory (resolved
through ``selection.json``, else the latest step) or a step path, npz or
the JAX package's orbax directories (``utils/orbax_read.py``).
``--device`` (default ``cuda``) picks the device; a missing GPU is an
error, never a quiet switch to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from mcmda_tpu_torch import config as config_mod


def _resolve_ckpt(path: str) -> str:
    """Accept a RUN DIRECTORY as --ckpt: resolve through selection.json
    (the unsupervised pick) when present, else the latest step.  Concrete
    step paths pass through unchanged."""
    if not os.path.isdir(path) or \
            os.path.basename(path.rstrip("/")).startswith("step_"):
        return path
    sel = os.path.join(path, "selection.json")
    if os.path.exists(sel):
        with open(sel) as f:
            step = json.load(f)["best_step"]
        cand = os.path.join(path, f"step_{step:08d}")
        if os.path.isdir(cand) or os.path.exists(cand + ".npz"):
            print(f"using selected checkpoint step {step} (selection.json)")
            return cand
    from mcmda_tpu_torch.utils import checkpoint
    step = checkpoint.latest_step(path)
    if step is not None:
        return os.path.join(path, f"step_{step:08d}")
    return path


def _selected_weights(ckpt_path: str) -> str | None:
    """The weight variant ("live"/"avg") the selection probe ranked best,
    from selection.json in the run directory, iff ``ckpt_path`` IS the
    selected step; None otherwise."""
    d = os.path.dirname(ckpt_path.rstrip("/"))
    base = os.path.basename(ckpt_path.rstrip("/"))
    sel = os.path.join(d, "selection.json")
    if not (base.startswith("step_") and os.path.exists(sel)):
        return None
    try:
        with open(sel) as f:
            rec = json.load(f)
        if base == f"step_{int(rec['best_step']):08d}":
            return rec.get("weights")
    except (KeyError, ValueError, OSError):
        pass
    return None


def _device(name: str, deterministic: bool = False) -> torch.device:
    """``--device`` through the shared helper (``utils/device.py``: TF32
    off on a GPU, deterministic cuDNN for the training commands); a missing
    GPU ends the command."""
    from mcmda_tpu_torch.utils import device as device_mod
    try:
        return device_mod.resolve(name, deterministic)
    except RuntimeError as e:
        raise SystemExit(f"--device {name}: {e}")


def _restore_eval_forward(cfg, args, device, use_kernel: bool = True):
    """Restore the checkpoint named by ``args.ckpt`` (already resolved) and
    build the eval forward ``images -> probs``: source-only or adapted,
    honoring ``--weights``, ``run.eval_bf16`` and ``run.use_pallas`` (the
    fused path; ``use_kernel=False`` runs it on the kernel's plain
    version)."""
    from mcmda_tpu_torch import api, weights

    cfg = config_mod.eval_view(cfg)
    if args.source_only:
        params, bn = weights.restore_source(args.ckpt, cfg, device)
        return api._eval_forward(cfg, params, bn, use_kernel=use_kernel)
    state = weights.restore_adapt(args.ckpt, cfg, device)
    if args.weights == "auto":
        # prefer the variant the selection probe ranked best; fall back
        # to the dam_ema heuristic for checkpoints without a selection
        rec = _selected_weights(args.ckpt)
        use_avg = (rec == "avg") if rec is not None \
            else cfg.adapt.dam_ema > 0
    else:
        use_avg = args.weights == "avg"
    if use_avg:
        print("evaluating EMA-averaged DAM weights "
              f"(adapt.dam_ema={cfg.adapt.dam_ema})")
    dam, bn = weights.eval_weights(state, use_avg)
    return api._eval_forward(cfg, state["src_params"], bn, dam,
                             use_kernel=use_kernel)


_PREDICT_EXTS = (".nii", ".nii.gz", ".hdr", ".hdr.gz", ".img", ".img.gz",
                 ".npz", ".npy")


def cmd_predict(args, use_kernel: bool = True):
    """Serving path: segmentation masks for UNLABELED volumes, written to
    disk (NIfTI/npz/npy, matching the input format by default).
    ``use_kernel=False`` serves the fused path on the kernel's plain
    version (the reference a GPU run is compared with)."""
    from mcmda_tpu_torch import api
    from mcmda_tpu_torch.data import splits, volumes as vio
    from mcmda_tpu_torch.evaluation import inference

    cfg = config_mod.load_config(args.config, args.set)
    device = _device(args.device)
    args.ckpt = _resolve_ckpt(args.ckpt)
    fwd, pp = api._serving(
        cfg, _restore_eval_forward(cfg, args, device, use_kernel),
        args.postprocess, args.tta)

    paths = []
    for inp in args.input:
        if os.path.isdir(inp):
            paths.extend(sorted(
                os.path.join(inp, f) for f in os.listdir(inp)
                if f.endswith(_PREDICT_EXTS)))
        else:
            paths.append(inp)
    if not paths:
        raise SystemExit(f"predict: no input volumes found in {args.input}")
    os.makedirs(args.out, exist_ok=True)

    written = []
    for p in paths:
        vol, spacing = vio.load_volume_with_spacing(p)
        if not args.no_normalize:
            vol = vio.normalize_volume(vol)
        pred = inference.predict_volume(
            fwd, vol, context=cfg.data.context_slices,
            batch_size=cfg.data.batch_size, device=device)
        if pp is not None:
            pred = pp(pred, splits.STRUCTURES)
        base = os.path.basename(p)
        for e in _PREDICT_EXTS:
            if base.endswith(e):
                stem = base[: -len(e)]
                # NIfTI-family inputs (incl. detached .hdr/.img) write
                # single-file .nii.gz; npz/npy keep their format
                ext = args.format or (
                    ".nii.gz" if e.startswith((".nii", ".hdr", ".img"))
                    else e)
                break
        out_path = os.path.join(args.out, f"{stem}_pred{ext}")
        vio.save_volume(out_path, pred.astype(np.uint8), spacing)
        vox = {splits.STRUCTURES.get(c, str(c)): int(n)
               for c, n in zip(*np.unique(pred, return_counts=True))
               if c != 0}
        print(f"{p} -> {out_path}  {vox}", flush=True)
        written.append(out_path)
    return written


def _get_data(args, cfg):
    """((src_vols, src_labs), tgt_train_vols, (tgt_test_vols,
    tgt_test_labs)) of ``--direction``: generated phantoms with
    ``--synthetic`` (the last quarter of the target volumes held out for
    test), else the MMWHS layout under ``--data-root``."""
    if args.synthetic:
        from mcmda_tpu_torch.data import synthetic
        size = cfg.data.slice_size
        depth = max(16, size // 4)
        src_dom, tgt_dom = (("mri", "ct") if args.direction == "mri2ct"
                            else ("ct", "mri"))
        sv, sl = synthetic.make_dataset(0, src_dom, args.synthetic_volumes,
                                        depth, size)
        tv, tl = synthetic.make_dataset(0, tgt_dom, args.synthetic_volumes,
                                        depth, size)
        n_test = max(1, args.synthetic_volumes // 4)
        return (sv, sl), tv[:-n_test], (tv[-n_test:], tl[-n_test:])
    from mcmda_tpu_torch.data import mmwhs
    if not args.data_root:
        raise SystemExit(f"{args.cmd}: pass --data-root or --synthetic")
    return mmwhs.load_benchmark(args.data_root, args.direction)


def cmd_train_source(args):
    """T1: supervised source-segmenter training, with the step and the feed
    of ``api.train_source`` (the dataset lives on the device and each step
    samples there when it is under the cutoff; a host sampler feeds the
    steps otherwise).  ``val_dice`` on the last source volume is logged at
    every checkpoint."""
    from mcmda_tpu_torch import api
    from mcmda_tpu_torch.data import volumes as vio
    from mcmda_tpu_torch.evaluation import report
    from mcmda_tpu_torch.train import loop, source
    from mcmda_tpu_torch.utils import checkpoint, logging as mlog

    cfg = config_mod.load_config(args.config, args.set)
    device = _device(args.device, deterministic=True)
    src_vols, src_labs = _get_data(args, cfg)[0]
    ds = vio.volumes_to_slices(src_vols, src_labs,
                               context=cfg.data.context_slices,
                               drop_empty=True)
    print(f"source training: {len(ds)} slices from {len(src_vols)} volumes",
          flush=True)
    state = source.init_state(cfg.run.seed, cfg, device)
    if args.from_ckpt:  # an explicit resume point beats --out's latest
        state = checkpoint.restore(_resolve_ckpt(args.from_ckpt), state)
        start = int(state.step)
    else:
        state, start = loop.maybe_resume(args.out, state)
    step_fn, feed, on_device = api._source_step_feed(cfg, ds, 0, device)
    print(f"feed path: {'device-resident' if on_device else 'host-sampler'}",
          flush=True)
    logger = mlog.MetricsLogger(os.path.join(args.out, "metrics.jsonl"),
                                tensorboard_dir=os.path.join(args.out, "tb"))
    # one forward for every callback: the state enters as fwd_args
    eval_raw = source.make_eval_forward(cfg)
    val_vol, val_lab = src_vols[-1], src_labs[-1]

    def val_fwd(img, params, bn_state):
        return eval_raw(params, bn_state, img)

    def val_cb(step_i, st, _metrics=None):
        agg = report.evaluate_volumes(
            val_fwd, [val_vol], [val_lab], context=cfg.data.context_slices,
            batch_size=cfg.data.batch_size,
            fwd_args=(st.params, st.bn_state), device=device)
        logger.log(step_i, {"val_dice": agg["mean"]["dice"]})

    loop.run(step_fn, state, feed, cfg.source.steps, seed=cfg.run.seed,
             log_every=cfg.run.log_every, ckpt_every=cfg.run.ckpt_every,
             ckpt_dir=args.out, logger=logger, start_step=start,
             callback=val_cb)
    logger.close()
    print(f"done; final checkpoint in {args.out}", flush=True)
    return 0


def cmd_adapt(args):
    """T3 + T2: the critic pretrain phase (``adapt.pretrain_steps``), then
    adversarial adaptation from a source checkpoint, with the steps and the
    feeds of ``api.adapt`` (device-resident under the cutoff, else two host
    samplers), checkpoint selection by ``adapt.select_signal``
    (``selection.json``, the selected checkpoint materialized at the end)
    and snapshot PNGs at every checkpoint."""
    from mcmda_tpu_torch import api, weights
    from mcmda_tpu_torch.data import volumes as vio
    from mcmda_tpu_torch.evaluation import snapshots
    from mcmda_tpu_torch.train import adapt, loop
    from mcmda_tpu_torch.utils import checkpoint, logging as mlog

    cfg = config_mod.load_config(args.config, args.set)
    device = _device(args.device, deterministic=True)
    (src_vols, src_labs), tgt_train, _ = _get_data(args, cfg)
    src_ds = vio.volumes_to_slices(src_vols, src_labs,
                                   context=cfg.data.context_slices,
                                   drop_empty=True)
    tgt_ds = vio.volumes_to_slices(tgt_train,
                                   context=cfg.data.context_slices)
    print(f"adaptation: {len(src_ds)} source / {len(tgt_ds)} target slices",
          flush=True)
    # K1 handoff: the source checkpoint goes into the frozen path and the DAM
    params, bn = weights.restore_source(_resolve_ckpt(args.source_ckpt), cfg,
                                        device)
    state = adapt.init_state(cfg.run.seed + 2, cfg, params, bn)
    if args.from_ckpt:
        state = checkpoint.restore(_resolve_ckpt(args.from_ckpt), state)
        start = int(state.step)
    else:
        state, start = loop.maybe_resume(args.out, state)
    mk_step, make_feed, on_device = api._adapt_step_feed(cfg, src_ds, tgt_ds,
                                                         0, device)
    print(f"feed path: {'device-resident' if on_device else 'host-sampler'}",
          flush=True)

    logger = mlog.MetricsLogger(os.path.join(args.out, "metrics.jsonl"),
                                tensorboard_dir=os.path.join(args.out, "tb"))
    snap_batch = tgt_ds.images[:4]
    snap_fwd = adapt.adapted_forward(cfg)

    def snapshot_cb(step, st, _metrics=None):
        with torch.no_grad():
            probs = snap_fwd(st, torch.from_numpy(
                np.ascontiguousarray(snap_batch, np.float32)).to(device))
        snapshots.save_snapshot(
            os.path.join(args.out, "snapshots", f"step_{step:08d}.png"),
            snap_batch, probs.argmax(-1).cpu().numpy())

    # unsupervised checkpoint selection: the primary signal per
    # adapt.select_signal, the other one logged; each probe tick scores the
    # live (and, with dam_ema, the averaged) weights and is read one tick
    # later
    eq_selector = adapt.EquilibriumSelector(
        warmup_step=cfg.adapt.pretrain_steps + cfg.adapt.steps // 5)
    cr_selector = api._class_ratio_selector(cfg, src_labs)
    selector = cr_selector if cfg.adapt.select_signal == "class_ratio" \
        else eq_selector
    select_probe = adapt.SelectionProbe(
        adapt.make_select_bundle(cfg, api._probe_images(tgt_ds),
                                 dual=cfg.adapt.dam_ema > 0),
        primary=selector, cr_selector=cr_selector, eq_selector=eq_selector,
        logger=logger, save_dir=args.out)

    if cfg.adapt.pretrain_steps and start < cfg.adapt.pretrain_steps:
        state, _ = loop.run(mk_step(train_g=False), state, make_feed(),
                            cfg.adapt.pretrain_steps, seed=cfg.run.seed + 5,
                            log_every=cfg.run.log_every, logger=logger,
                            start_step=start)
        start = cfg.adapt.pretrain_steps
    state, _ = loop.run(mk_step(), state, make_feed(),
                        cfg.adapt.pretrain_steps + cfg.adapt.steps,
                        seed=cfg.run.seed + 6, log_every=cfg.run.log_every,
                        ckpt_every=cfg.run.ckpt_every, ckpt_dir=args.out,
                        logger=logger, start_step=start,
                        callback=snapshot_cb,
                        probe_every=api._select_every(cfg, cfg.adapt.steps),
                        probe=select_probe,
                        protect_steps=select_probe.protect_steps)
    select_probe.finalize()  # the last deferred tick + the smoothing tail
    best = selector.best_step
    if best is not None:
        print(f"selected checkpoint ({selector.signal}): step {best} "
              f"(score {selector.best_score:.4f})", flush=True)
        if api._materialize_pick(args.out, state, select_probe, selector):
            print(f"materialized selected checkpoint at step {best}",
                  flush=True)
    logger.close()
    print(f"done; final checkpoint in {args.out}", flush=True)
    return 0


def cmd_evaluate(args, use_kernel: bool = True):
    """Dice / ASSD / HD95 of a checkpoint on the labelled target test
    volumes, through the eval forward ``predict`` serves (the fused path
    under ``run.use_pallas``).  Prints the table and returns the metrics;
    ``--json-out`` writes them."""
    from mcmda_tpu_torch import api
    from mcmda_tpu_torch.data import splits
    from mcmda_tpu_torch.evaluation import report

    cfg = config_mod.load_config(args.config, args.set)
    device = _device(args.device)
    args.ckpt = _resolve_ckpt(args.ckpt)
    _, _, (test_vols, test_labs) = _get_data(args, cfg)
    fwd, pp = api._serving(
        cfg, _restore_eval_forward(cfg, args, device, use_kernel),
        args.postprocess, args.tta)
    agg = report.evaluate_volumes(fwd, test_vols, test_labs,
                                  context=cfg.data.context_slices,
                                  batch_size=cfg.data.batch_size,
                                  structures=splits.STRUCTURES,
                                  postprocess=pp, device=device)
    if pp is not None:
        print("raw predictions:")
        print(report.format_table(agg["raw"]))
        print("largest-connected-component filtered:")
    print(report.format_table(agg), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(agg, f, indent=2)
    return agg


def build_parser():
    p = argparse.ArgumentParser(prog="mcmda_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    def common(sp):
        sp.add_argument("--config", default=None,
                        help="ExperimentConfig JSON (default: built-in)")
        sp.add_argument("--set", action="append", metavar="K.EY=VAL",
                        help="config override, e.g. source.steps=100")
        sp.add_argument("--direction", default="mri2ct",
                        choices=["mri2ct", "ct2mri"])
        sp.add_argument("--data-root", default=None,
                        help="MMWHS root (see data/mmwhs.py layout)")
        sp.add_argument("--synthetic", action="store_true",
                        help="use the generated phantom dataset")
        sp.add_argument("--synthetic-volumes", type=int, default=4)
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")

    sp = sub.add_parser("train-source", help="supervised source training")
    common(sp)
    sp.add_argument("--out", required=True)
    sp.add_argument("--from-ckpt", default=None,
                    help="explicit resume checkpoint (default: --out latest)")
    sp.set_defaults(fn=cmd_train_source)

    sp = sub.add_parser("adapt", help="critic pretrain + adaptation")
    common(sp)
    sp.add_argument("--source-ckpt", required=True,
                    help="source run dir or step checkpoint")
    sp.add_argument("--out", required=True)
    sp.add_argument("--from-ckpt", default=None,
                    help="explicit resume checkpoint (default: --out latest)")
    sp.set_defaults(fn=cmd_adapt)

    sp = sub.add_parser("evaluate", help="Dice / ASSD on the target test set")
    common(sp)
    sp.add_argument("--ckpt", required=True,
                    help="run dir (resolves selection.json) or npz "
                         "checkpoint")
    sp.add_argument("--source-only", action="store_true")
    sp.add_argument("--json-out", default=None)
    sp.add_argument("--weights", default="auto",
                    choices=["auto", "live", "avg"],
                    help="adapted eval weights: EMA-averaged DAM (avg), the "
                         "live DAM (live), or the selected / dam_ema>0 "
                         "variant (auto)")
    sp.add_argument("--postprocess", default=None, choices=["none", "cc"],
                    help="default: run.eval_postprocess")
    sp.add_argument("--tta", default=None, choices=["none", "flip"],
                    help="default: run.eval_tta")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser(
        "predict", help="serving: write segmentation masks for unlabeled "
                        "volumes (NIfTI/npz/npy)")
    sp.add_argument("--config", default=None,
                    help="ExperimentConfig JSON (default: built-in)")
    sp.add_argument("--set", action="append", metavar="K.EY=VAL",
                    help="config override, e.g. run.use_pallas=true")
    sp.add_argument("--ckpt", required=True,
                    help="run dir (resolves selection.json) or npz "
                         "checkpoint")
    sp.add_argument("--input", required=True, nargs="+",
                    help="volume file(s) or directory of volumes")
    sp.add_argument("--out", required=True, help="output directory")
    sp.add_argument("--source-only", action="store_true",
                    help="use the source segmenter (no DAM)")
    sp.add_argument("--weights", default="auto",
                    choices=["auto", "live", "avg"])
    sp.add_argument("--postprocess", default=None, choices=["none", "cc"],
                    help="default: run.eval_postprocess")
    sp.add_argument("--tta", default=None, choices=["none", "flip"],
                    help="default: run.eval_tta")
    sp.add_argument("--format", default=None,
                    choices=[".nii", ".nii.gz", ".npz", ".npy"],
                    help="output format (default: match the input)")
    sp.add_argument("--no-normalize", action="store_true",
                    help="input volumes are already normalized (benchmark "
                         "releases); default applies the training-time "
                         "per-volume normalization")
    sp.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    sp.set_defaults(fn=cmd_predict)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    ret = args.fn(args)
    return ret if isinstance(ret, int) else 0


if __name__ == "__main__":
    sys.exit(main())
