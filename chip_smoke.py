#!/usr/bin/env python3
"""Smoke test of the PyTorch port's serving path on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure ends the run non-zero):

1. device: the card (``nvidia-smi`` name and power limit), torch / CUDA
   versions; TF32 pinned off so f32 means f32.
2. build: compiles the hand-written CUDA kernel from the checkout's sources.
3. kernel: the fused conv+BN+activation kernel against its plain PyTorch
   version at every call-site shape of the full-width serving forward
   (batch 8, and 16 for flip TTA), f32 and the bf16 inputs the
   ``eval_bf16`` flow gives it; max abs error and median times of both.
4. predict: ``python -m mcmda_tpu_torch predict`` at full width
   (configs/mri2ct.json, run.use_pallas=true) on a 64-slice 256x256 phantom
   from seeded random weights written in the JAX package's npz layout:
   source-only and adapted with flip TTA in the shipped bf16 serving
   precision, and source-only in f32.  Checks the masks, that the kernel ran
   exactly once per fused call site per forward batch, and that the masks
   match the same run on the kernel's plain version on the card (see
   RUNS); times both paths.

The line before the last is a JSON object of kernel results; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "mri2ct.json")
BATCH = 8
SLICES = 64
SIZE = 256
SEED = 0
DEVICE = "cuda"
SETS = ["run.use_pallas=true"]
# kernel vs plain, both f32 with TF32 off; they differ only in the order of
# up to 9*512 summed products
RTOL, ATOL = 1e-4, 1e-4
# std of the random model's logits over the first batch (see _calibrate_head)
LOGIT_SPREAD = 8.0
# Phase 4 runs: (name, extra predict args, least kernel/plain agreement of
# the masks).  In f32 the two paths differ only in the fused convs'
# summation order and must agree in 99.9% of voxels.  The shipped config
# serves in bf16 (run.eval_bf16): the strided blocks and the head round the
# fused convs' f32 output to bf16, and a last-bit difference that flips one
# rounding grows through the random network, so kernel/plain agreement is
# lower; it is held to 99.5% and, below, to being no further (within
# EXACT_SLACK) from the masks of an f64 fused conv than the plain path is.
RUNS = (
    ("source-only", ["--source-only"], 0.995),
    ("adapted", ["--tta", "flip"], 0.995),
    ("source-only f32", ["--source-only", "--set", "run.eval_bf16=false"],
     0.999),
)
EXACT_SLACK = 0.001
TIMED_RUNS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def call_sites(cfg, n: int, size: int):
    """The fused conv calls of ``segmenter.apply_fused_eval`` in order, as
    (site, (n,h,w,c), k, dilation, x dtype, residual dtype or None) under
    the config's compute dtype: the stem and both convs of every stride-1
    block.  Strided blocks return the compute dtype, fused calls f32, so a
    block after a strided one gets its input (conv1) and its residual
    (conv2) in the compute dtype."""
    low = cfg.compute_dtype
    sites, h, cin, h_dt = [], size, cfg.in_channels, "float32"
    for spec in cfg.stages:
        if spec.name == "stem":
            sites.append(("stem", (n, h, h, cin), spec.features, 1, h_dt,
                          None))
            cin, h_dt = spec.features, "float32"
            continue
        for i in range(spec.blocks):
            if i == 0 and spec.stride != 1:
                h //= spec.stride
                cin, h_dt = spec.features, low
                continue
            k = spec.features
            # conv2's residual is the block input, or the f32 projection
            res_dt = "float32" if cin != k else h_dt
            sites.append((f"{spec.name}.b{i}.conv1", (n, h, h, cin), k,
                          spec.dilation, h_dt, None))
            sites.append((f"{spec.name}.b{i}.conv2", (n, h, h, k), k,
                          spec.dilation, "float32", res_dt))
            cin, h_dt = k, "float32"
    return sites


def gpu_time_ms(fn, torch) -> float:
    """Median of TIMED_RUNS runs after warmup, each timed with CUDA events
    between two synchronizations."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_kernel(cfg, torch, fk):
    """Phase 3: kernel vs plain at every call-site shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # batch 8, and 16 for the double batch of flip TTA
    per_batch = {n: call_sites(cfg, n, SIZE) for n in (BATCH, 2 * BATCH)}
    cases = {}
    for _, xs, k, d, x_dt, r_dt in sum(per_batch.values(), []):
        cases[(xs, k, d, r_dt and "float32", "float32", "relu")] = None
        cases[(xs, k, d, r_dt, x_dt, "relu")] = None
        if r_dt == "bfloat16":  # both inputs bf16
            cases[(xs, k, d, r_dt, r_dt, "relu")] = None
    # the other activations the kernel offers, at one tail shape
    for act in ("leaky_relu", "none"):
        cases[((BATCH, 32, 32, 128), 128, 2, "float32", "float32", act)] = \
            None
    worst = 0.0
    for xs, k, d, r_dt, x_dt, act in cases:
        c = xs[-1]
        x = torch.randn(xs, device="cuda", generator=gen).to(
            getattr(torch, x_dt))
        w = torch.randn((3, 3, c, k), device="cuda", generator=gen) \
            * math.sqrt(2.0 / (9 * c))
        scale = torch.rand(k, device="cuda", generator=gen) + 0.5
        bias = torch.randn(k, device="cuda", generator=gen) * 0.1
        r = (torch.randn(xs[:3] + (k,), device="cuda", generator=gen)
             .to(getattr(torch, r_dt)) if r_dt else None)
        kw = dict(dilation=d, activation=act, residual=r)
        got = fk.conv_bn_act(x, w, scale, bias, **kw)
        torch.cuda.synchronize()
        ref = fk.conv_bn_act_reference(x, w, scale, bias, **kw)
        if got.dtype != torch.float32 or got.shape != ref.shape:
            fail(f"kernel output {got.dtype} {tuple(got.shape)}")
        err = (got - ref).abs().max().item()
        worst = max(worst, err)
        ok = torch.allclose(got, ref, rtol=RTOL, atol=ATOL)
        t_k = gpu_time_ms(lambda: fk.conv_bn_act(x, w, scale, bias, **kw),
                          torch)
        t_p = gpu_time_ms(
            lambda: fk.conv_bn_act_reference(x, w, scale, bias, **kw), torch)
        cases[(xs, k, d, r_dt, x_dt, act)] = (t_k, t_p)
        print(f"kernel x={list(xs)} {x_dt} k={k} d={d} residual={r_dt} "
              f"{act}: "
              f"max_abs_err={err:.3e} kernel_ms={t_k:.4f} "
              f"plain_ms={t_p:.4f}", flush=True)
        if not ok:
            fail(f"kernel disagrees with plain at x={xs} {x_dt} k={k} "
                 f"d={d} residual={r_dt} {act}: max abs err {err}")
    # one forward batch's worth: each call site at its serving dtypes
    totals = {}
    for n, sites in per_batch.items():
        totals[n] = [sum(cases[(xs, k, d, r_dt, x_dt, "relu")][i]
                         for _, xs, k, d, x_dt, r_dt in sites)
                     for i in (0, 1)]
        print(f"kernel: {len(sites)} call sites per forward batch of {n}: "
              f"kernel {totals[n][0]:.3f} ms, plain {totals[n][1]:.3f} ms",
              flush=True)
    print(f"kernel: {len(cases)} cases agree (rtol={RTOL}, atol={ATOL}), "
          f"max abs err {worst:.3e}", flush=True)
    return worst, totals[BATCH][0], totals[BATCH][1], len(per_batch[BATCH])


def _random_trees(cfg, rng, segmenter):
    """Seeded He-normal convs and non-trivial BN statistics in the JAX
    package's tree layout, as numpy arrays."""
    params, state = segmenter.init(cfg.segmenter, device="meta")

    def fill(node, name=""):
        if isinstance(node, dict):
            return {k: fill(v, k) for k, v in node.items()}
        shape = tuple(node.shape)
        if name == "w":
            fan_in = shape[0] * shape[1] * shape[2]
            return (rng.standard_normal(shape)
                    * math.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.0, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(1.0, 3.0, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return fill(params), fill(state)


def _perturbed(tree, rng, scale=0.05):
    if isinstance(tree, dict):
        return {k: _perturbed(v, rng, scale) for k, v in tree.items()}
    return (tree * (1 + scale * rng.standard_normal(tree.shape))
            ).astype(np.float32)


def _calibrate_head(cfg, params, state, vol, torch):
    """Set the head so that, over the first batch, every class's mean logit
    is 0 and the logits spread with std LOGIT_SPREAD: a confident model
    whose masks mix the classes.  Uncalibrated random weights give one
    class almost everywhere."""
    from mcmda_tpu_torch.data import volumes
    from mcmda_tpu_torch.models import segmenter

    def to_dev(node):
        if isinstance(node, dict):
            return {k: to_dev(v) for k, v in node.items()}
        return torch.from_numpy(node).to(DEVICE)

    x = volumes.stack_context(volumes.normalize_volume(vol), 3)[:BATCH]
    with torch.inference_mode():
        logits, _ = segmenter.apply_fused_eval(
            to_dev(params), to_dev(state),
            torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE),
            cfg.segmenter, use_kernel=False)
    logits = logits.float()
    mean = logits.mean((0, 1, 2))
    gain = LOGIT_SPREAD / (logits - mean).std().item()
    head = params["head"]
    head["b"] = ((head["b"] - mean.cpu().numpy()) * gain).astype(np.float32)
    head["w"] = (head["w"] * gain).astype(np.float32)


def write_inputs(cfg, tmp, torch):
    """Source and adapted npz checkpoints in the JAX key layout and a
    phantom volume; returns their paths."""
    from mcmda_tpu_torch import weights
    from mcmda_tpu_torch.data import synthetic, volumes
    from mcmda_tpu_torch.models import segmenter

    rng = np.random.default_rng(SEED)
    vol, _ = synthetic.make_volume(rng, "ct", depth=SLICES, size=SIZE)
    vol_path = os.path.join(tmp, "in", "case1.nii.gz")
    os.makedirs(os.path.dirname(vol_path))
    volumes.save_nifti(vol_path, vol, np.array([2.0, 0.8, 0.8]))
    params, state = _random_trees(cfg, rng, segmenter)
    _calibrate_head(cfg, params, state, vol, torch)
    src = os.path.join(tmp, "source", "step_00000001.npz")
    os.makedirs(os.path.dirname(src))
    np.savez(src, **weights.flatten(params, "params"),
             **weights.flatten(state, "bn_state"),
             **{".step": np.asarray(1, np.int32)})
    dam, _ = segmenter.dam_split(params, cfg.segmenter, cfg.adapt.plug_depth)
    ada = os.path.join(tmp, "adapt", "step_00000002.npz")
    os.makedirs(os.path.dirname(ada))
    np.savez(ada, **weights.flatten(params, "src_params"),
             **weights.flatten(state, "src_bn"),
             **weights.flatten(_perturbed(dam, rng), "dam_params"),
             **weights.flatten(_perturbed(state, rng), "tgt_bn"),
             **{".step": np.asarray(2, np.int32)})
    return src, ada, vol_path


def phase_predict(cfg, torch, fk, n_sites):
    """Phase 4: full-width predict through the CLI (see RUNS); returns the
    kernel launches of the runs."""
    from mcmda_tpu_torch import cli
    from mcmda_tpu_torch.data import volumes
    from mcmda_tpu_torch.ops import layers

    def exact(x, w, scale, bias, *, dilation=1, activation="relu",
              residual=None):
        """The plain version in f64, rounded to f32: the answer that both
        f32 versions approximate, each with its own summation order."""
        f64 = torch.float64
        y = layers.conv_apply({"w": w}, x, dilation=dilation,
                              compute_dtype=f64)
        y = y * scale.to(f64) + bias.to(f64)
        if residual is not None:
            y = y + residual.to(f64)
        return fk._activate(y, activation).float()

    batches = -(-SLICES // BATCH)
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        src, ada, vol_path = write_inputs(cfg, tmp, torch)
        for name, extra, min_agree in RUNS:
            ckpt = src if "--source-only" in extra else ada
            argv = ["predict", "--config", CONFIG,
                    *(a for kv in SETS for a in ("--set", kv)),
                    "--ckpt", os.path.dirname(ckpt),
                    "--input", vol_path, "--device", DEVICE, *extra]
            outs = {v: os.path.join(tmp, f"out_{name}_{v}".replace(" ", "_"))
                    for v in ("kernel", "plain", "exact")}
            torch.cuda.synchronize()
            fk.LAUNCHES = 0
            t0 = time.perf_counter()
            rc = cli.main(argv + ["--out", outs["kernel"]])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = fk.LAUNCHES
            launches += n
            if rc != 0:
                fail(f"predict {name} returned {rc}")
            if n != n_sites * batches:
                fail(f"predict {name}: {n} kernel launches, expected "
                     f"{n_sites} x {batches} batches")
            args = cli.build_parser().parse_args(argv + ["--out",
                                                         outs["plain"]])
            cli.cmd_predict(args, use_kernel=False)
            real = fk.conv_bn_act_reference
            fk.conv_bn_act_reference = exact
            try:
                cli.cmd_predict(cli.build_parser().parse_args(
                    argv + ["--out", outs["exact"]]), use_kernel=False)
            finally:
                fk.conv_bn_act_reference = real
            masks = {}
            for v, d in outs.items():
                masks[v], sp = volumes.load_volume_with_spacing(
                    os.path.join(d, "case1_pred.nii.gz"))
                if not np.allclose(sp, [2.0, 0.8, 0.8]):
                    fail(f"predict {name} {v}: spacing {sp}")
            mask = masks["kernel"]
            if mask.shape != (SLICES, SIZE, SIZE):
                fail(f"predict {name}: mask shape {mask.shape}")
            if not set(np.unique(mask).tolist()) <= set(range(5)):
                fail(f"predict {name}: labels {np.unique(mask)}")

            def agree(a, b):
                return 1.0 - int((masks[a] != masks[b]).sum()) / mask.size

            kp, ke, pe = (agree("kernel", "plain"), agree("kernel", "exact"),
                          agree("plain", "exact"))
            counts = np.bincount(mask.astype(np.int64).ravel(), minlength=5)
            t_k, t_p, probs_err, ties = time_forward(cfg, torch, cli, args,
                                                     vol_path, volumes)
            print(f"predict {name}: mask {list(mask.shape)} classes "
                  f"{counts.tolist()}; kernel launches {n} = {n_sites} x "
                  f"{batches} batches; voxel agreement kernel/plain {kp:.6f}"
                  f" ({int(round((1 - kp) * mask.size))} differ), "
                  f"kernel/exact {ke:.6f}, plain/exact {pe:.6f}; cli wall "
                  f"{wall:.2f} s; predict_volume kernel {t_k:.1f} ms/volume "
                  f"({1000 / t_k:.2f} volumes/s), plain {t_p:.1f} ms/volume;"
                  f" batch-0 probs max abs diff {probs_err:.3e}, top-2 gap "
                  f"< 1/128 in {100 * ties:.3f}% of voxels", flush=True)
            if kp < min_agree:
                fail(f"predict {name}: kernel/plain agreement {kp} < "
                     f"{min_agree}")
            if ke < pe - EXACT_SLACK:
                fail(f"predict {name}: the kernel path is further from the "
                     f"f64 answer than the plain path ({ke} < {pe})")
    return launches


def time_forward(cfg, torch, cli, args, vol_path, volumes):
    """Steady-state predict_volume time (median of 3, ms per volume) of the
    kernel and the plain forward, and the max abs difference of their probs
    on the first batch (which must be finite and sum to 1)."""
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.evaluation import inference

    cfg = config_mod.load_config(args.config, args.set)
    vol = volumes.normalize_volume(
        volumes.load_volume_with_spacing(vol_path)[0])
    device = torch.device(DEVICE)
    tta = inference.get_tta(args.tta or cfg.run.eval_tta) or (lambda f: f)
    out = []
    probs = []
    for use_kernel in (True, False):
        fwd = tta(cli._restore_eval_forward(cfg, args, device, use_kernel))
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inference.predict_volume(fwd, vol, context=3, batch_size=BATCH,
                                     device=device)
            times.append((time.perf_counter() - t0) * 1000)
        out.append(statistics.median(times[1:]))
        p = inference.predict_volume_probs(fwd, vol[:BATCH], context=3,
                                           batch_size=BATCH, device=device)
        if p.shape != (BATCH, SIZE, SIZE, 5) or not np.isfinite(p).all():
            fail(f"probs {p.shape} finite={np.isfinite(p).all()}")
        if not np.allclose(p.sum(-1), 1.0, atol=2e-2):
            fail("probs do not sum to 1")
        probs.append(p)
    top2 = np.sort(probs[0], axis=-1)[..., -2:]
    ties = float(np.mean(top2[..., 1] - top2[..., 0] < 1 / 128))
    return out[0], out[1], float(np.abs(probs[0] - probs[1]).max()), ties


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    sys.path.insert(0, ROOT)
    try:
        from mcmda_tpu_torch import config as config_mod
        from mcmda_tpu_torch.kernels import build
        from mcmda_tpu_torch.kernels import fused_conv as fk
    except ImportError as e:
        fail(f"run from the root of a checkout ({e})")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"device: {kind}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 off",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = build.build()
    with open(os.path.join(os.path.dirname(lib), "nvcc.log")) as f:
        ptxas = [ln.split(":", 1)[1].strip() for ln in f if "Used" in ln]
    print(f"build: {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s; ptxas per instantiation: "
          f"{' | '.join(ptxas)}", flush=True)

    cfg = config_mod.eval_view(config_mod.load_config(CONFIG, SETS))

    # 3. kernel vs plain
    worst, ms, plain_ms, n_sites = phase_kernel(cfg.segmenter, torch, fk)

    # 4. full-width predict
    launches = phase_predict(cfg, torch, fk, n_sites)

    print(json.dumps({"kernels": [{
        "name": "conv_bn_act",
        "route": "cuda",
        "source": "mcmda_tpu_torch/kernels/csrc/fused_conv.cu",
        "replaces": "mcmda_tpu/kernels/fused_conv.py:101",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
