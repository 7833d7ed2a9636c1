#!/usr/bin/env python3
"""Smoke test of the PyTorch port's serving and source-training paths on one
NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure ends the run non-zero):

1. device: the card (``nvidia-smi`` name and power limit), torch / CUDA
   versions; TF32 pinned off so f32 means f32.
2. build: compiles the hand-written CUDA kernels from the checkout's
   sources (one nvcc per source, in parallel).
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
5. train kernels: the augmentation warp kernel against its plain version
   (batch 8, 256x256, 3 image + 5 label channels and 3 image channels;
   both flip states and an identity transform), and the conv + BN-moments
   kernel against its plain version at the 6 shapes of the 15 convs of a
   train step at batch 8 that take it (``train_call_sites``: z, the
   moments, and the gradients of its autograd Function at 512->512 d4);
   max abs errors and median times.
6. train-source: ``python -m mcmda_tpu_torch train-source --synthetic`` at
   full width through the CLI (see TRAIN_RUNS): the kernel path with
   checkpoints, prune and val_dice firing; the shipped config; the plain
   path.  Checks the launch counts per step, finite and falling losses,
   the step-1 loss of the kernel path against the plain path, bitwise
   repeatable losses, and that the final checkpoint serves through
   ``predict``; times ``make_train_step`` on both paths.

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
# phase 5: the warp computes its coordinates bitwise like the plain version,
# so only the f32 blend's rounding differs
WARP_ATOL = 1e-5
# conv + moments: z as the fused conv (RTOL, ATOL); each channel's sum and
# sum of squares within MOMENT_RTOL of sum|z| and sum z^2 (the summation
# order over 8192 pixels differs); gradients within GRAD_RTOL of the
# largest |gradient| (cuDNN's transposed convs on both sides, fed the same
# cotangent up to rounding)
MOMENT_RTOL = 1e-4
GRAD_RTOL = 1e-4
# phase 6: (name, extra train-source --set overrides, steps, warp launches
# per step, conv-moments launches per step).  The JAX package sends 15
# convs of a default-stage train forward to its conv + moments kernel: the
# 12 stride-1 convs of rm4-rm6 and the 3 stride-1 128->128 convs of rm3
# (``train_call_sites``); the port sends the same 15.
TRAIN_STEPS = 30
TRAIN_RUNS = (
    ("kernel", ["segmenter.train_fused=pallas", "run.ckpt_every=10"],
     TRAIN_STEPS, 1, 15),
    ("kernel-5a", ["segmenter.train_fused=pallas"], 5, 1, 15),
    ("kernel-5b", ["segmenter.train_fused=pallas"], 5, 1, 15),
    ("shipped", [], 5, 1, 0),
    ("plain", ["data.warp=xla", "segmenter.train_fused=none"], 5, 0, 0),
)
STEP1_RTOL = 1e-3


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


def train_call_sites(cfg, n: int, size: int):
    """The convs of a train-mode forward that take the conv + BN-moments
    path (``blocks._fused_ok`` with train_fused on), as
    ((n,h,w,c), k, dilation) in order."""
    import torch

    from mcmda_tpu_torch.ops import blocks

    sites, h, cin = [], size, cfg.in_channels
    for spec in cfg.stages:
        if spec.name == "stem":
            cin = spec.features
            continue
        for i in range(spec.blocks):
            stride = spec.stride if i == 0 else 1
            # conv1 reads the block input, conv2 the strided output; only
            # stride-1 convs qualify, so h is each one's input size
            for c, s, hh in ((cin, stride, h),
                             (spec.features, 1, h // stride)):
                if blocks._fused_ok(True, True, s, torch.float32,
                                    (3, 3, c, spec.features)):
                    sites.append(((n, hh, hh, c), spec.features,
                                  spec.dilation))
            h //= stride
            cin = spec.features
    return sites


def phase_train_kernels(cfg, torch, wk, tk, pipeline):
    """Phase 5: the warp and the conv + BN-moments kernels against their
    plain versions; returns the kernels' JSON fields (without launches)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # warp: draws over the config's ranges, alternating flips, the last
    # image the identity transform
    draws = pipeline.draw_params(gen, cfg.data, BATCH, "cuda")
    draws[:, 0] = (torch.arange(BATCH, device="cuda") % 2).float()
    draws[-1] = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0])
    coefs = wk.affine_coefs(*draws[:, 1:].unbind(-1), draws[:, 0], SIZE,
                            SIZE)
    k = cfg.data.num_classes
    image = torch.randn((BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    label = torch.nn.functional.one_hot(
        torch.randint(0, k, (BATCH, SIZE, SIZE), device="cuda",
                      generator=gen), k).float()
    warp = {}
    for name, packed in (("image+label", torch.cat([image, label], -1)),
                         ("image", image.contiguous())):
        got = wk.warp_affine(packed, coefs, n_image=3)
        torch.cuda.synchronize()
        ref = wk.warp_affine_reference(packed, coefs, n_image=3)
        err = (got - ref).abs().max().item()
        if not torch.isfinite(got).all() or got.shape != ref.shape:
            fail(f"warp {name}: output not finite or shape {got.shape}")
        t_k = gpu_time_ms(lambda: wk.warp_affine(packed, coefs, n_image=3),
                          torch)
        t_p = gpu_time_ms(
            lambda: wk.warp_affine_reference(packed, coefs, n_image=3), torch)
        warp[name] = (err, t_k, t_p)
        print(f"warp {name} x={list(packed.shape)}: max_abs_err={err:.3e} "
              f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f}", flush=True)
        if err > WARP_ATOL:
            fail(f"warp {name}: max abs err {err} > {WARP_ATOL}")
    # identity image: the input itself (labels renormalised one-hots)
    same = wk.warp_affine(torch.cat([image, label], -1), coefs, n_image=3)
    if not torch.equal(same[-1], torch.cat([image, label], -1)[-1]):
        fail("warp: the identity transform does not return its input")

    sites = train_call_sites(cfg.segmenter, BATCH, SIZE)
    shapes = {}
    for xs, kk, d in sites:
        shapes[(xs, kk, d)] = shapes.get((xs, kk, d), 0) + 1
    worst, t_k_step, t_p_step = 0.0, 0.0, 0.0
    for (xs, kk, d), count in shapes.items():
        c = xs[-1]
        x = torch.randn(xs, device="cuda", generator=gen)
        w = torch.randn((3, 3, c, kk), device="cuda", generator=gen) \
            * math.sqrt(2.0 / (9 * c))
        z, s1, s2 = tk.conv_stats_forward(x, w, d)
        torch.cuda.synchronize()
        rz, r1, r2 = tk.conv_stats_reference(x, w, d)
        err = (z - rz).abs().max().item()
        worst = max(worst, err)
        m1 = ((s1 - r1).abs() / rz.abs().sum((0, 1, 2))).max().item()
        m2 = ((s2 - r2).abs() / torch.square(rz).sum((0, 1, 2))).max().item()
        t_k = gpu_time_ms(lambda: tk.conv_stats_forward(x, w, d), torch)
        t_p = gpu_time_ms(lambda: tk.conv_stats_reference(x, w, d), torch)
        t_k_step += count * t_k
        t_p_step += count * t_p
        print(f"conv_stats x={list(xs)} k={kk} d={d} ({count} per step): "
              f"z max_abs_err={err:.3e}, sum rel {m1:.2e}, sumsq rel "
              f"{m2:.2e}; kernel_ms={t_k:.4f} plain_ms={t_p:.4f}",
              flush=True)
        if not torch.allclose(z, rz, rtol=RTOL, atol=ATOL):
            fail(f"conv_stats z disagrees at x={xs} k={kk} d={d}: {err}")
        if max(m1, m2) > MOMENT_RTOL:
            fail(f"conv_stats moments disagree at x={xs} k={kk} d={d}: "
                 f"{m1}, {m2}")
    if len(sites) != TRAIN_RUNS[0][4]:
        fail(f"{len(sites)} conv + moments sites per step, expected "
             f"{TRAIN_RUNS[0][4]}")
    print(f"conv_stats: {len(sites)} calls per train step: kernel "
          f"{t_k_step:.3f} ms, plain {t_p_step:.3f} ms (forward)",
          flush=True)
    # gradients of a scalar of (z, sum, sumsq) at 512 -> 512 d4
    xs, kk, d = (BATCH, SIZE // 8, SIZE // 8, 512), 512, 4
    x = torch.randn(xs, device="cuda", generator=gen)
    w = torch.randn((3, 3, 512, kk), device="cuda", generator=gen) \
        * math.sqrt(2.0 / (9 * 512))
    grads = []
    for fn in (tk.conv_stats,
               lambda a, b, dd: tk.conv_stats_reference(a, b, dd)):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        z, s1, s2 = fn(xg, wg, d)
        cnt = z.shape[0] * z.shape[1] * z.shape[2]
        f = torch.tanh(z).sum() + torch.square(s1 / cnt).sum() \
            + torch.sqrt(s2 / cnt).sum()
        grads.append(torch.autograd.grad(f, (xg, wg)))
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(*grads)]
    print(f"conv_stats grads x={list(xs)} k={kk} d={d}: dx rel "
          f"{rel[0]:.2e}, dw rel {rel[1]:.2e}", flush=True)
    if max(rel) > GRAD_RTOL:
        fail(f"conv_stats gradients disagree: {rel}")
    w_err = max(v[0] for v in warp.values())
    return {
        "warp_affine": dict(max_abs_err=w_err, ms=warp["image+label"][1],
                            plain_ms=warp["image+label"][2]),
        "conv_stats": dict(max_abs_err=worst, ms=t_k_step,
                           plain_ms=t_p_step),
    }


def _losses(out_dir):
    """Per-step losses of a train-source run, from its metrics.jsonl."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return ([r["loss"] for r in recs if "loss" in r],
            [r["val_dice"] for r in recs if "val_dice" in r])


def phase_train(torch, wk, tk, fk):
    """Phase 6: full-width train-source through the CLI (TRAIN_RUNS), the
    final checkpoint served by predict, and make_train_step timed on the
    kernel and the plain path; returns ([warp launches, conv-moments
    launches] of the runs, {path: ms/step})."""
    from mcmda_tpu_torch import cli, weights
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.data import synthetic, volumes
    from mcmda_tpu_torch.utils import tree

    launches = [0, 0]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, sets, steps, n_warp, n_conv in TRAIN_RUNS:
            out = os.path.join(tmp, name)
            argv = ["train-source", "--config", CONFIG, "--synthetic",
                    "--out", out, "--device", DEVICE]
            for kv in [f"source.steps={steps}", "run.log_every=1", *sets]:
                argv += ["--set", kv]
            torch.cuda.synchronize()
            wk.LAUNCHES = tk.LAUNCHES = 0
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = (wk.LAUNCHES, tk.LAUNCHES)
            launches[0] += got[0]
            launches[1] += got[1]
            if rc != 0:
                fail(f"train-source {name} returned {rc}")
            losses, dice = _losses(out)
            runs[name] = losses
            print(f"train-source {name}: {steps} steps, cli wall {wall:.1f} "
                  f"s; launches warp {got[0]}, conv_stats {got[1]}; loss "
                  f"first {losses[0]:.6f} last {losses[-1]:.6f}; val_dice "
                  f"{[round(d, 4) for d in dice]}; checkpoints "
                  f"{sorted(os.listdir(out))}", flush=True)
            if got != (n_warp * steps, n_conv * steps):
                fail(f"train-source {name}: launches {got}, expected "
                     f"{(n_warp * steps, n_conv * steps)}")
            if len(losses) != steps or not np.isfinite(losses).all():
                fail(f"train-source {name}: losses {losses}")
        full = runs["kernel"]
        first, last = np.mean(full[:10]), np.mean(full[-10:])
        rel = abs(full[0] - runs["plain"][0]) / abs(runs["plain"][0])
        print(f"train-source: kernel path mean loss first 10 {first:.6f}, "
              f"last 10 {last:.6f}; step-1 loss kernel {full[0]!r} plain "
              f"{runs['plain'][0]!r} (rel {rel:.2e}); two 5-step kernel "
              f"runs {'equal' if runs['kernel-5a'] == runs['kernel-5b'] else 'DIFFER'}",
              flush=True)
        if not last < first:
            fail(f"kernel path loss did not fall: {first} -> {last}")
        if rel > STEP1_RTOL:
            fail(f"step-1 loss kernel/plain rel diff {rel} > {STEP1_RTOL}")
        if runs["kernel-5a"] != runs["kernel-5b"]:
            fail(f"seeded kernel runs differ: {runs['kernel-5a']} vs "
                 f"{runs['kernel-5b']}")
        if _losses(os.path.join(tmp, "kernel"))[1] == []:
            fail("val_dice never logged")
        # the trained checkpoint, served
        cfg = config_mod.load_config(CONFIG)
        ckpt = os.path.join(tmp, "kernel", f"step_{TRAIN_STEPS:08d}")
        params, bn = weights.restore_source(ckpt, cfg, DEVICE)
        rng = np.random.default_rng(SEED)
        vol, _ = synthetic.make_volume(rng, "mri", depth=16, size=SIZE)
        vol_path = os.path.join(tmp, "in", "case1.npz")
        os.makedirs(os.path.dirname(vol_path))
        volumes.save_volume(vol_path, vol)
        pred_dir = os.path.join(tmp, "pred")
        fk.LAUNCHES = 0
        rc = cli.main(["predict", "--config", CONFIG, "--ckpt",
                       os.path.join(tmp, "kernel"), "--input", vol_path,
                       "--out", pred_dir, "--source-only", "--device",
                       DEVICE, *(a for kv in SETS for a in ("--set", kv))])
        mask = volumes.load_volume_with_spacing(
            os.path.join(pred_dir, "case1_pred.npz"))[0]
        counts = np.bincount(mask.astype(np.int64).ravel(), minlength=5)
        print(f"predict from the trained checkpoint: mask {list(mask.shape)}"
              f" classes {counts.tolist()}, fused conv launches "
              f"{fk.LAUNCHES}", flush=True)
        if rc != 0 or mask.shape != (16, SIZE, SIZE) or \
                not set(np.unique(mask).tolist()) <= set(range(5)):
            fail(f"predict from the trained checkpoint: rc {rc}, mask "
                 f"{mask.shape} {np.unique(mask)}")
        if not all(torch.isfinite(t).all() for t in
                   tree.leaves(params) + tree.leaves(bn)):
            fail("restored checkpoint not finite")
    return launches, time_train_step(torch)


def time_train_step(torch):
    """Median ms/step of make_train_step over TIMED_RUNS steps after 5
    warm-up steps, on the kernel path and the plain path (same data)."""
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.data import pipeline, synthetic, volumes
    from mcmda_tpu_torch.train import source

    base = config_mod.load_config(CONFIG)
    vols, labs = synthetic.make_dataset(0, "mri", 4, max(16, SIZE // 4), SIZE)
    ds = volumes.volumes_to_slices(vols, labs, context=3, drop_empty=True)
    data = pipeline.to_device_arrays(ds, base.data.num_classes, DEVICE)
    out = {}
    for name, sets in (("kernel", ["segmenter.train_fused=pallas"]),
                       ("plain", ["data.warp=xla",
                                  "segmenter.train_fused=none"])):
        cfg = config_mod.load_config(CONFIG, sets)
        state = source.init_state(cfg.run.seed, cfg, DEVICE)
        step = source.make_train_step(cfg, sample_from_device=True)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(5 + TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, data, i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000)
        if not math.isfinite(float(metrics["loss"])):
            fail(f"timed {name} step: loss {metrics['loss']}")
        out[name] = statistics.median(times[5:])
        print(f"train step {name}: {out[name]:.2f} ms/step (median of "
              f"{TIMED_RUNS} after 5 warm-up; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)",
              flush=True)
        del state
    return out


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
        from mcmda_tpu_torch.data import pipeline
        from mcmda_tpu_torch.kernels import build
        from mcmda_tpu_torch.kernels import fused_conv as fk
        from mcmda_tpu_torch.kernels import train_conv as tk
        from mcmda_tpu_torch.kernels import warp as wk
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

    # 5. train kernels vs plain
    train_cfg = config_mod.load_config(CONFIG)
    fields = phase_train_kernels(train_cfg, torch, wk, tk, pipeline)

    # 6. full-width train-source
    (warp_launches, conv_launches), step_ms = phase_train(torch, wk, tk, fk)
    print(f"train step ms: kernel path {step_ms['kernel']:.2f}, plain path "
          f"{step_ms['plain']:.2f}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "conv_bn_act",
        "route": "cuda",
        "source": "mcmda_tpu_torch/kernels/csrc/fused_conv.cu",
        "replaces": "mcmda_tpu/kernels/fused_conv.py:101",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "conv_stats",
        "route": "cuda",
        "source": "mcmda_tpu_torch/kernels/csrc/train_conv.cu",
        "replaces": "mcmda_tpu/kernels/train_conv.py:100",
        "launches": conv_launches,
        **fields["conv_stats"],
    }, {
        "name": "warp_affine",
        "route": "cuda",
        "source": "mcmda_tpu_torch/kernels/csrc/warp.cu",
        "replaces": "mcmda_tpu/kernels/warp.py:150",
        "launches": warp_launches,
        **fields["warp_affine"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
