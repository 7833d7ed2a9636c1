"""Command-line entry points: the ``train-source`` and ``predict``
subcommands of the JAX package's CLI (``mcmda_tpu/cli.py``), on PyTorch::

    python -m mcmda_tpu_torch train-source --config configs/mri2ct.json \\
        --synthetic --out runs/src --set segmenter.train_fused=pallas
    python -m mcmda_tpu_torch predict --config configs/mri2ct.json \\
        --ckpt runs/adapt --input vols/ --out preds/ --set run.use_pallas=true

``train-source`` writes ``step_XXXXXXXX.npz`` checkpoints in the JAX
package's key layout.  ``--ckpt`` takes a run directory (resolved through
``selection.json``, else the latest step) or a step path; only npz
checkpoints are read.  ``--device`` (default ``cuda``) picks the device; a
missing GPU is an error, never a quiet switch to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np
import torch

from mcmda_tpu_torch import config as config_mod


def _latest_step(ckpt_dir: str) -> int | None:
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)(\.npz)?$", n))]
    return max(steps) if steps else None


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
    step = _latest_step(path)
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


def _device(name: str) -> torch.device:
    """The device to run on.  On a GPU, f32 convs and matmuls are pinned to
    full f32: cuDNN would otherwise run f32 convs in TF32."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: no CUDA device available "
                             "(pass --device cpu to serve on the CPU)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def _restore_eval_forward(cfg, args, device, use_kernel: bool = True):
    """Restore the checkpoint named by ``args.ckpt`` (already resolved) and
    build the eval forward ``images -> probs``: source-only or adapted,
    honoring ``--weights``, ``run.eval_bf16`` and ``run.use_pallas`` (the
    fused path; ``use_kernel=False`` runs it on the kernel's plain
    version)."""
    from mcmda_tpu_torch import weights
    from mcmda_tpu_torch.models import segmenter

    cfg = config_mod.eval_view(cfg)
    if args.source_only:
        params, bn = weights.restore_source(args.ckpt, cfg, device)
        dam, plug_depth = None, None
    else:
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
        params = state["src_params"]
        dam, bn = weights.eval_weights(state, use_avg)
        plug_depth = cfg.adapt.plug_depth
    if cfg.run.use_pallas:
        return lambda img: segmenter.apply_fused_eval(
            params, bn, img, cfg.segmenter, dam_params=dam,
            plug_depth=plug_depth, use_kernel=use_kernel)[1]
    return lambda img: segmenter.apply(
        params, bn, img, cfg.segmenter, dam_params=dam,
        plug_depth=plug_depth)[1]


_PREDICT_EXTS = (".nii", ".nii.gz", ".hdr", ".hdr.gz", ".img", ".img.gz",
                 ".npz", ".npy")


def cmd_predict(args, use_kernel: bool = True):
    """Serving path: segmentation masks for UNLABELED volumes, written to
    disk (NIfTI/npz/npy, matching the input format by default).
    ``use_kernel=False`` serves the fused path on the kernel's plain
    version (the reference a GPU run is compared with)."""
    from mcmda_tpu_torch.data import splits, volumes as vio
    from mcmda_tpu_torch.evaluation import inference, postprocess as pp_mod

    cfg = config_mod.load_config(args.config, args.set)
    device = _device(args.device)
    args.ckpt = _resolve_ckpt(args.ckpt)
    fwd = _restore_eval_forward(cfg, args, device, use_kernel)
    tta = inference.get_tta(args.tta if args.tta is not None
                            else cfg.run.eval_tta)
    if tta is not None:
        fwd = tta(fwd)
    pp = pp_mod.get(args.postprocess if args.postprocess is not None
                    else cfg.run.eval_postprocess)

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
    """Labeled source volumes (vols, labels) of ``--direction``: generated
    phantoms with ``--synthetic``, else the MMWHS layout under
    ``--data-root``."""
    if args.synthetic:
        from mcmda_tpu_torch.data import synthetic
        size = cfg.data.slice_size
        src_dom = "mri" if args.direction == "mri2ct" else "ct"
        return synthetic.make_dataset(0, src_dom, args.synthetic_volumes,
                                      max(16, size // 4), size)
    from mcmda_tpu_torch.data import mmwhs
    if not args.data_root:
        raise SystemExit("train-source: pass --data-root or --synthetic")
    return mmwhs.load_benchmark(args.data_root, args.direction)[0]


def cmd_train_source(args):
    """T1: supervised source-segmenter training.  The dataset lives on the
    device and each step samples there when it is under 1 GiB; a host
    sampler feeds the steps otherwise.  ``val_dice`` on the last source
    volume is logged at every checkpoint."""
    import itertools

    from mcmda_tpu_torch.data import pipeline, volumes as vio
    from mcmda_tpu_torch.evaluation import report
    from mcmda_tpu_torch.train import loop, source
    from mcmda_tpu_torch.utils import checkpoint, logging as mlog

    cfg = config_mod.load_config(args.config, args.set)
    device = _device(args.device)
    if device.type == "cuda":
        # deterministic cuDNN algorithms: a seeded run repeats bit for bit
        torch.backends.cudnn.deterministic = True
    src_vols, src_labs = _get_data(args, cfg)
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
    on_device = ds.images.nbytes < 1 << 30
    print(f"feed path: {'device-resident' if on_device else 'host-sampler'}",
          flush=True)
    if on_device:
        step_fn = source.make_train_step(cfg, sample_from_device=True)
        feed = itertools.repeat(pipeline.to_device_arrays(
            ds, cfg.data.num_classes, device))
    else:
        step_fn = source.make_train_step(cfg)
        feed = pipeline.to_device(iter(pipeline.BatchSampler(
            ds, cfg.data.batch_size, seed=cfg.run.seed + 1,
            num_classes=cfg.data.num_classes)), device)
    logger = mlog.MetricsLogger(os.path.join(args.out, "metrics.jsonl"),
                                tensorboard_dir=os.path.join(args.out, "tb"))
    eval_fwd = source.make_eval_forward(cfg)
    val_vol, val_lab = src_vols[-1], src_labs[-1]

    def val_cb(step_i, st, _metrics=None):
        agg = report.evaluate_volumes(
            lambda img: eval_fwd(st.params, st.bn_state, img), [val_vol],
            [val_lab], context=cfg.data.context_slices,
            batch_size=cfg.data.batch_size, device=device)
        logger.log(step_i, {"val_dice": agg["mean"]["dice"]})

    loop.run(step_fn, state, feed, cfg.source.steps, seed=cfg.run.seed,
             log_every=cfg.run.log_every, ckpt_every=cfg.run.ckpt_every,
             ckpt_dir=args.out, logger=logger, start_step=start,
             callback=val_cb)
    logger.close()
    print(f"done; final checkpoint in {args.out}", flush=True)
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="mcmda_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("train-source", help="supervised source training")
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
    sp.add_argument("--out", required=True)
    sp.add_argument("--from-ckpt", default=None,
                    help="explicit resume checkpoint (default: --out latest)")
    sp.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    sp.set_defaults(fn=cmd_train_source)

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
