#!/usr/bin/env python3
"""Smoke test of the PyTorch port's serving, training and adaptation paths
and of its library API on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure ends the run non-zero):

1. device: the card (``nvidia-smi`` name and power limit), torch / CUDA
   versions; TF32 pinned off by the port's device helper, so f32 means
   f32.
2. build: compiles the hand-written CUDA kernels from the checkout's
   sources (one nvcc per source, in parallel); prints ptxas's registers,
   shared memory and spills per kernel instantiation; no kernel may spill.
3. kernel: the fused conv+BN+activation kernel against its plain PyTorch
   version at every call-site shape of the full-width serving forward
   (batch 8, and 16 for flip TTA), f32 and the bf16 inputs the
   ``eval_bf16`` flow gives it; max abs error and median times of both;
   then the f64 control per call-site shape at batch 1 (the kernel's error
   against an f64 conv at most F64_RATIO times the plain f32 conv's).
4. predict: ``python -m mcmda_tpu_torch predict`` at full width
   (configs/mri2ct.json, run.use_pallas=true) on a 64-slice 256x256 phantom
   from seeded random weights written in the JAX package's npz layout:
   source-only and adapted with flip TTA in the shipped bf16 serving
   precision, and source-only in f32.  Checks the masks, that the kernel ran
   exactly once per fused call site per forward batch, and that the masks
   match the same run on the kernel's plain version on the card (see
   RUNS); times both paths.
5. train kernels: the augmentation warp kernel against its plain version
   (batch 8, 256x256, 3 image + 5 label channels and 3 image channels, and
   adapt's batch 16; both flip states and an identity transform): image
   channels bitwise equal, labels within WARP_ATOL, two calls bitwise
   equal; a small shape that takes its generic kernel; and the conv +
   BN-moments kernel against its plain version at the 6 shapes of the 15
   convs of a
   train step at batch 8 that take it (``train_call_sites``: z, the
   moments, the f64 control of z at batch 1, and the gradients of its
   autograd Function at 512->512 d4); max abs errors and median times (the
   warp's both on one buffer and out of the L2).
6. train-source: ``python -m mcmda_tpu_torch train-source --synthetic`` at
   full width through the CLI (see TRAIN_RUNS): the kernel path with
   checkpoints, prune and val_dice firing; the shipped config; the plain
   path.  Checks the launch counts per step, finite and falling losses,
   the step-1 loss of the kernel path against the plain path, bitwise
   repeatable losses, and that the final checkpoint serves through
   ``predict``; times ``make_train_step`` on both paths.
7. thin stem: ``thin_conv.stem_apply_cf`` in train mode at [8,256,256,3]
   -> 16 through the stem kernel (forward, dw, BN, ReLU) against the plain
   conv under autograd: y, dw, dx (None by default, and with input_grad);
   times the kernel (on one buffer and out of the L2), the plain version
   and cuDNN's conv; then launches on two streams with different weights,
   and a width that is no multiple of 4.
8. adapt: ``python -m mcmda_tpu_torch adapt --synthetic`` at full width
   from phase 6's kernel run (see ADAPT_RUNS): the kernel path for 30 steps
   with checkpoints, snapshots and class-ratio selection; two 5-step
   kernel runs (bitwise equal losses); the shipped config; the plain path;
   one step each of the kernel and the plain path with f32 source features
   (step-1 losses of each kernel/plain pair within STEP1_RTOL).
   Checks the launches per step, finite losses, selection.json, the
   materialized selected checkpoint and the snapshot PNGs; times
   ``make_adapt_step`` on both paths.
9. evaluate: ``python -m mcmda_tpu_torch evaluate`` of phase 8's kernel run
   on the fused path (run.use_pallas): it resolves selection.json, the
   fused conv runs once per call site per forward batch, and the Dice /
   ASSD table is finite; ``predict`` serves the same selected checkpoint.
10. api: ``api.train_source -> api.adapt -> api.evaluate -> api.predict``
   at full width (see API_SETS) on the device-resident feed (step
   counters, finite losses, selection.json and the materialized pick, a
   finite table, uint8 masks, launches per step and per forward batch);
   the same seeds through the CLI (every checkpoint bitwise equal); the
   host-sampler feed (``api._ON_DEVICE_BYTES = 0``) through
   ``prefetch_to_device`` and through a synchronous feed of the same
   sampler stream (losses and final states bitwise equal); an
   ``out_dir=None`` run that writes nothing; ms/step and
   ``profiling.measure_step`` of the host-sampler steps with both feeds.
11. quality: the seed-sweep twin (``mcmda_tpu_torch/scripts/seed_sweep.py``)
   at full width on 2 volumes of 16 slices, 20 source and 2 x 40 adapt
   steps, a probe every 10 (artifact keys against the reference's
   ``results/mri2ct_seed_sweep_r5.json``, a ``--first-seed 1 --merge``
   rerun bitwise equal); the synthetic-benchmark twin for mri2ct at 10 + 10
   steps with ``run.use_pallas`` on ``evaluate``; the e2e example twin on
   the card (its plain paths: no kernel launch).  Launches held to 1 warp +
   15 conv + moments per training step and 19 fused convs per forward
   batch.

Every kernel is timed beside its bound and a PyTorch call computing the
same or the core of the same function (``library_ms``; for the convs
cuDNN's f32 conv with TF32 off, of x widened to f32).  A bound is the
larger of the bytes the kernel must move at 3.35 TB/s and its operations
at the rate of the units that run them: the two conv kernels run split
TF32 on the tensor cores, so each multiply-add counts as 3 TF32 products
(2 where x is bf16) at 495 TFLOP/s, with the bound at the f32 CUDA-core
rate of 67 TFLOP/s printed beside it; the warp and the stem run on the
CUDA cores.  The warp's and the stem's whole working set (34-40 MB) fits
the card's 50 MB L2, so 20 calls on one buffer may be served by it: their
``ms`` (and ``library_ms``) rotate over COLD_SETS distinct buffers and are
what the bound is compared with; ``one_buffer_ms`` is the timing of earlier
versions of this script.  The line before the last is a JSON object of
kernel results (the fused conv's also at batch 16); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
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
# kernel vs plain: the plain convs run f32 with TF32 off, the conv kernels
# split TF32 (f32-class: see F64_RATIO); they differ in the rounding and
# the order of up to 9*512 summed products
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
# distinct input / output buffers a small kernel's cold timing rotates over
# (each set is 34-50 MB at the warp's and the stem's shapes; the L2 is 50)
COLD_SETS = 6
# about 2.5 ms of the card's clock: longer than the host takes to enqueue
# one timed call
SPIN_CYCLES = 5_000_000
# phase 5: the warp computes its coordinates and its blend bitwise like the
# plain version (the image channels are held to torch.equal); only the order
# of the label sum, and so the renormalised labels' last bits, may differ
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
# phase 8: (name, extra adapt --set overrides, steps, warp launches per
# step, conv-moments launches per step).  The shipped config runs the
# frozen source forward in bf16 (adapt.src_feats_bf16), which takes no conv
# + moments call; the one shared target forward per step takes 15, and an
# f32 source forward 15 more.
ADAPT_STEPS = 30
F32_SRC = "adapt.src_feats_bf16=false"
ADAPT_RUNS = (
    ("kernel", ["segmenter.train_fused=pallas", "run.ckpt_every=10"],
     ADAPT_STEPS, 1, 15),
    ("kernel-5a", ["segmenter.train_fused=pallas"], 5, 1, 15),
    ("kernel-5b", ["segmenter.train_fused=pallas"], 5, 1, 15),
    ("shipped", [], 5, 1, 0),
    ("plain", ["data.warp=xla", "segmenter.train_fused=none"], 5, 0, 0),
    ("kernel-f32", ["segmenter.train_fused=pallas", F32_SRC], 1, 1, 30),
    ("plain-f32", ["data.warp=xla", "segmenter.train_fused=none", F32_SRC],
     1, 0, 0),
)
# step-1 losses of the kernel path against the plain path are held to
# STEP1_RTOL with f32 source features and in the shipped bf16 source
# forward alike: the warp kernel's image channels are bitwise its plain
# version's, so what is left between the two paths is the flip folded into
# the warp's coefficients (an ulp of the sampling coordinates of flipped
# images against flip-then-warp) and the conv + moments kernel's summation
# order (2.0e-4 on d_loss in bf16 measured on an H100).  The shipped run
# (warp kernel, plain convs) against the kernel run isolates the conv +
# moments kernel.
# H100 SXM peaks (NVIDIA's data sheet): device memory, f32 CUDA cores and
# dense TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
# the conv kernels run each f32 product as three TF32 tensor-core products
# (split TF32, csrc/conv_tile.cuh), two when x is bf16 (exact in TF32)
SPLIT_PRODUCTS = {"float32": 3, "bfloat16": 2}
# f64 control: a conv kernel's max abs error against an f64 conv is at most
# F64_RATIO times the plain f32 conv's (TF32 off)
F64_RATIO = 4.0


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


def ptxas_report(log: str):
    """(kernel, registers, spill-store bytes, static shared bytes) per
    compiled kernel in ptxas's ``-v`` report; conv kernels are named by x
    dtype and tile width, e.g. ``conv_bn_act_kernel<bf16,128>``, the warp
    and stem kernels by their integer template arguments, e.g.
    ``stem_conv_kernel<16,3,1>`` (K, C, x read 16 bytes at a time)."""
    out = []
    for m in re.finditer(
            r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
            r"(\d+) bytes spill stores.*\n.*Used (\d+) registers(.*)", log):
        mangled, spill, regs, rest = m.groups()
        name = re.search(r"\d+([a-z_]+_kernel)", mangled).group(1)
        tile = re.search(r"TileILi(\d+)E", mangled)
        args = re.search(name + r"I((?:L[ib]\d+E)+)E", mangled)
        if tile:
            dt = "bf16" if "bfloat16" in mangled else "f32"
            name += f"<{dt},{tile.group(1)}>"
        elif args:
            name += "<" + ",".join(re.findall(r"L[ib](\d+)E",
                                              args.group(1))) + ">"
        smem = re.search(r"(\d+) bytes smem", rest)
        out.append((name, int(regs), int(spill),
                    int(smem.group(1)) if smem else 0))
    return out


def gpu_time_ms(fn, torch) -> float:
    """Median of TIMED_RUNS runs after warmup, each timed with CUDA events
    between two synchronizations.  A spin kernel queued ahead of the first
    event keeps the card busy while the host enqueues ``fn``, so the events
    time the device work, not the host's launch overhead (which is most of
    a call of a few tens of microseconds)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def gpu_time_cold_ms(fn, sets, torch) -> float:
    """As ``gpu_time_ms``, out of the L2: call i runs ``fn(*sets[i %
    len(sets)])`` and its result is kept until ``len(sets)`` later calls
    have made theirs, so inputs and outputs rotate over distinct buffers
    that together exceed the card's 50 MB L2 several times.  20 calls on
    one buffer of a few tens of MB can read it from the L2 and come in
    under a bound computed from the device memory's rate."""
    ring = [None] * len(sets)
    i = 0

    def call():
        nonlocal i
        ring[i % len(sets)] = fn(*sets[i % len(sets)])
        i += 1

    return gpu_time_ms(call, torch)


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS):
    """(least ms for the work, what bounds it): the bytes at the card's
    memory rate against the operations at ``flops_per_s`` (by default its
    f32 CUDA-core rate)."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def conv_bounds(work):
    """Bounds of a list of conv calls (bytes, flops, split products): the
    split-TF32 tensor-core bound (each multiply-add as that many TF32
    products at 495 TFLOP/s) and, for comparison with the f32 kernels of
    earlier versions, the f32 CUDA-core bound; both as (ms, what bounds
    it)."""
    nbytes = sum(b for b, _, _ in work)
    return (bound(nbytes, sum(f * p for _, f, p in work), TF32_FLOPS),
            bound(nbytes, sum(f for _, f, _ in work)))


def f64_control(torch, x, w, dilation, kernel, label):
    """Max abs error of ``kernel(x, w, dilation)`` (a conv, no epilogue)
    and of the plain f32 conv against an f64 conv; fails unless the
    kernel's is within F64_RATIO of the plain one's."""
    from mcmda_tpu_torch.ops import layers

    exact = layers.conv_apply({"w": w}, x, dilation=dilation,
                              compute_dtype=torch.float64)
    got = kernel(x, w, dilation)
    torch.cuda.synchronize()
    err = (got.double() - exact).abs().max().item()
    plain = (layers.conv_apply({"w": w}, x, dilation=dilation).double()
             - exact).abs().max().item()
    print(f"{label} f64 control x={list(x.shape)} {str(x.dtype)[6:]} "
          f"k={w.shape[-1]} d={dilation}: kernel {err:.3e}, plain f32 "
          f"{plain:.3e} (ratio {err / plain:.2f}, limit {F64_RATIO})",
          flush=True)
    if err > F64_RATIO * plain:
        fail(f"{label}: kernel error vs f64 {err} > {F64_RATIO} x plain "
             f"{plain} at x={tuple(x.shape)} k={w.shape[-1]} d={dilation}")


def conv_work(xs, k, x_bytes, out_bytes, extra_bytes=0):
    """(bytes, flops) of a 3x3 conv of NHWC x of shape ``xs`` to k
    channels: x, the f32 weights and the output once each, plus
    ``extra_bytes``; 2 operations per multiply-add."""
    n, h, w, c = xs
    px = n * h * w
    return (px * c * x_bytes + 9 * c * k * 4 + px * k * out_bytes
            + extra_bytes, 2.0 * px * 9 * c * k)


def library_conv(torch, x, w, dilation):
    """cuDNN's f32 conv (TF32 off) of NHWC x (a channels-last view, widened
    to f32 beforehand where x is bf16, as the kernel computes in f32) with
    HWIO w: the library call beside a conv kernel."""
    import torch.nn.functional as F

    wl = w.permute(3, 2, 0, 1).contiguous()
    xl = x.float().permute(0, 3, 1, 2)
    return lambda: F.conv2d(xl, wl, padding=dilation, dilation=dilation)


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
        t_l = gpu_time_ms(library_conv(torch, x, w, d), torch)
        cases[(xs, k, d, r_dt, x_dt, act)] = (t_k, t_p, t_l)
        print(f"kernel x={list(xs)} {x_dt} k={k} d={d} residual={r_dt} "
              f"{act}: "
              f"max_abs_err={err:.3e} kernel_ms={t_k:.4f} "
              f"plain_ms={t_p:.4f} library_ms={t_l:.4f}", flush=True)
        if not ok:
            fail(f"kernel disagrees with plain at x={xs} {x_dt} k={k} "
                 f"d={d} residual={r_dt} {act}: max abs err {err}")
    # one forward batch's worth: each call site at its serving dtypes
    totals = {}
    for n, sites in per_batch.items():
        totals[n] = [sum(cases[(xs, k, d, r_dt, x_dt, "relu")][i]
                         for _, xs, k, d, x_dt, r_dt in sites)
                     for i in (0, 1, 2)]
        print(f"kernel: {len(sites)} call sites per forward batch of {n}: "
              f"kernel {totals[n][0]:.3f} ms, plain {totals[n][1]:.3f} ms, "
              f"library conv {totals[n][2]:.3f} ms", flush=True)
    size = {"float32": 4, "bfloat16": 2}
    bounds = {}
    for n, sites in per_batch.items():
        work = [conv_work(xs, k, size[x_dt], 4,
                          2 * k * 4 + (xs[0] * xs[1] * xs[2] * k * size[r_dt]
                                       if r_dt else 0))
                + (SPLIT_PRODUCTS[x_dt],)
                for _, xs, k, d, x_dt, r_dt in sites]
        bounds[n] = conv_bounds(work)
        (b_ms, b_by), (f_ms, f_by) = bounds[n]
        print(f"kernel: bound per forward batch of {n}: {b_ms:.4f} ms "
              f"({b_by}, split TF32 at {TF32_FLOPS / 1e12:.0f} TFLOP/s); on "
              f"the f32 CUDA cores {f_ms:.4f} ms ({f_by})", flush=True)
    print(f"kernel: {len(cases)} cases agree (rtol={RTOL}, atol={ATOL}), "
          f"max abs err {worst:.3e}", flush=True)
    # f64 control at batch 1, per call-site shape and x dtype
    one = {(xs[1:], k, d, x_dt) for _, xs, k, d, x_dt, _ in per_batch[BATCH]}
    for hwc, k, d, x_dt in sorted(one):
        c = hwc[-1]
        x = torch.randn((1,) + hwc, device="cuda", generator=gen).to(
            getattr(torch, x_dt))
        w = torch.randn((3, 3, c, k), device="cuda", generator=gen) \
            * math.sqrt(2.0 / (9 * c))
        f64_control(torch, x, w, d, lambda a, b, dd: fk.conv_bn_act(
            a, b, torch.ones(k, device="cuda"), torch.zeros(k, device="cuda"),
            dilation=dd, activation="none"), "kernel")
    (b_ms, b_by), (f_ms, _) = bounds[BATCH]
    return (len(per_batch[BATCH]),
            dict(max_abs_err=worst, ms=totals[BATCH][0],
                 plain_ms=totals[BATCH][1], bound_ms=b_ms, bound_by=b_by,
                 library_ms=totals[BATCH][2], f32_core_bound_ms=f_ms,
                 batch16_ms=totals[2 * BATCH][0],
                 batch16_plain_ms=totals[2 * BATCH][1],
                 batch16_library_ms=totals[2 * BATCH][2],
                 batch16_bound_ms=bounds[2 * BATCH][0][0]))


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
    # image of each batch the identity transform.  Train-source warps a
    # batch of 8 with its labels; adapt warps the 16 images of the source
    # and target batches together.
    draws = pipeline.draw_params(gen, cfg.data, 2 * BATCH, "cuda")
    draws[:, 0] = (torch.arange(2 * BATCH, device="cuda") % 2).float()
    draws[BATCH - 1] = draws[-1] = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0])
    coefs2 = wk.affine_coefs(*draws[:, 1:].unbind(-1), draws[:, 0], SIZE,
                             SIZE)
    coefs = coefs2[:BATCH].contiguous()
    k = cfg.data.num_classes
    image = torch.randn((BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    label = torch.nn.functional.one_hot(
        torch.randint(0, k, (BATCH, SIZE, SIZE), device="cuda",
                      generator=gen), k).float()
    image2 = torch.randn((2 * BATCH, SIZE, SIZE, 3), device="cuda",
                         generator=gen)
    warp = {}
    for name, packed, cf in (
            ("image+label", torch.cat([image, label], -1), coefs),
            ("image", image.contiguous(), coefs),
            ("adapt image", image2, coefs2)):
        got = wk.warp_affine(packed, cf, n_image=3)
        torch.cuda.synchronize()
        ref = wk.warp_affine_reference(packed, cf, n_image=3)
        err = (got - ref).abs().max().item()
        if not torch.isfinite(got).all() or got.shape != ref.shape:
            fail(f"warp {name}: output not finite or shape {got.shape}")
        if not torch.equal(got[..., :3], ref[..., :3]):
            fail(f"warp {name}: image channels not bitwise the plain "
                 f"version's ({(got[..., :3] != ref[..., :3]).sum().item()} "
                 "values differ)")
        if not torch.equal(got, wk.warp_affine(packed, cf, n_image=3)):
            fail(f"warp {name}: two calls on the same inputs differ")
        lib = library_warp(torch, wk, cf)
        sets = [(packed.clone(),) for _ in range(COLD_SETS)]
        t_k = gpu_time_ms(lambda: wk.warp_affine(packed, cf, n_image=3),
                          torch)
        t_kc = gpu_time_cold_ms(
            lambda p: wk.warp_affine(p, cf, n_image=3), sets, torch)
        t_p = gpu_time_ms(
            lambda: wk.warp_affine_reference(packed, cf, n_image=3), torch)
        t_l = gpu_time_ms(lambda: lib(packed), torch)
        t_lc = gpu_time_cold_ms(lib, sets, torch)
        del sets
        c = packed.shape[-1]
        px = packed.shape[0] * SIZE * SIZE
        # coordinates 8 ops and corner weights 8 per pixel, the blend 7
        # per channel, the label renormalisation 2 per label channel
        b_ms, b_by = bound(2 * px * c * 4 + cf.numel() * 4,
                           px * (16 + 7 * c + 2 * (c - 3)))
        warp[name] = dict(max_abs_err=err, ms=t_kc, one_buffer_ms=t_k,
                          plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                          library_ms=t_lc, library_one_buffer_ms=t_l)
        print(f"warp {name} x={list(packed.shape)}: max_abs_err={err:.3e}, "
              f"image channels bitwise equal; kernel_ms={t_kc:.4f} out of "
              f"L2 ({t_k:.4f} on one buffer) plain_ms={t_p:.4f} "
              f"grid_sample_ms={t_lc:.4f} ({t_l:.4f}) bound_ms={b_ms:.4f} "
              f"({b_by})"
              + ("; the one-buffer time is under the bound: the L2's, not "
                 "device memory's" if t_k < b_ms else ""), flush=True)
        if err > WARP_ATOL:
            fail(f"warp {name}: max abs err {err} > {WARP_ATOL}")
    # identity image: the input itself (labels renormalised one-hots)
    same = wk.warp_affine(torch.cat([image, label], -1), coefs, n_image=3)
    same2 = wk.warp_affine(image2, coefs2, n_image=3)
    if not (torch.equal(same[-1], torch.cat([image, label], -1)[-1])
            and torch.equal(same2[-1], image2[-1])):
        fail("warp: the identity transform does not return its input")
    # a shape that takes the generic kernel (run-time C, ragged tiles)
    gh, gw, gc, gn = 37, 41, 5, 2
    g_coefs = wk.affine_coefs(*draws[:2, 1:].unbind(-1), draws[:2, 0], gh, gw)
    g_x = torch.rand((2, gh, gw, gc), device="cuda", generator=gen)
    g_got = wk.warp_affine(g_x, g_coefs, n_image=gn)
    torch.cuda.synchronize()
    g_ref = wk.warp_affine_reference(g_x, g_coefs, n_image=gn)
    g_err = (g_got - g_ref).abs().max().item()
    print(f"warp generic x={list(g_x.shape)} n_image={gn}: max_abs_err="
          f"{g_err:.3e}", flush=True)
    if g_err > WARP_ATOL or not torch.equal(g_got[..., :gn], g_ref[..., :gn]):
        fail(f"warp generic: max abs err {g_err} > {WARP_ATOL}, or image "
             "channels not bitwise the plain version's")

    sites = train_call_sites(cfg.segmenter, BATCH, SIZE)
    shapes = {}
    for xs, kk, d in sites:
        shapes[(xs, kk, d)] = shapes.get((xs, kk, d), 0) + 1
    worst, t_k_step, t_p_step, t_l_step = 0.0, 0.0, 0.0, 0.0
    work = []
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
        t_l = gpu_time_ms(library_conv(torch, x, w, d), torch)
        t_k_step += count * t_k
        t_p_step += count * t_p
        t_l_step += count * t_l
        b, f = conv_work(xs, kk, 4, 4, 2 * kk * 4)
        work += [(b, f, SPLIT_PRODUCTS["float32"])] * count
        print(f"conv_stats x={list(xs)} k={kk} d={d} ({count} per step): "
              f"z max_abs_err={err:.3e}, sum rel {m1:.2e}, sumsq rel "
              f"{m2:.2e}; kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f}", flush=True)
        if not torch.allclose(z, rz, rtol=RTOL, atol=ATOL):
            fail(f"conv_stats z disagrees at x={xs} k={kk} d={d}: {err}")
        if max(m1, m2) > MOMENT_RTOL:
            fail(f"conv_stats moments disagree at x={xs} k={kk} d={d}: "
                 f"{m1}, {m2}")
        f64_control(torch, x[:1].contiguous(), w, d,
                    lambda a, b, dd: tk.conv_stats_forward(a, b, dd)[0],
                    "conv_stats")
    if len(sites) != TRAIN_RUNS[0][4]:
        fail(f"{len(sites)} conv + moments sites per step, expected "
             f"{TRAIN_RUNS[0][4]}")
    (c_ms, c_by), (f_ms, f_by) = conv_bounds(work)
    print(f"conv_stats: {len(sites)} calls per train step: kernel "
          f"{t_k_step:.3f} ms, plain {t_p_step:.3f} ms, library conv "
          f"{t_l_step:.3f} ms, bound {c_ms:.4f} ms ({c_by}, split TF32) "
          f"(forward); on the f32 CUDA cores {f_ms:.4f} ms ({f_by})",
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
    w_err = max(max(v["max_abs_err"] for v in warp.values()), g_err)
    return {
        "warp_affine": {**warp["image+label"], "max_abs_err": w_err,
                        **{f"adapt_{k}": v for k, v
                           in warp["adapt image"].items()
                           if k.endswith("ms")}},
        "conv_stats": dict(max_abs_err=worst, ms=t_k_step,
                           plain_ms=t_p_step, bound_ms=c_ms, bound_by=c_by,
                           library_ms=t_l_step, f32_core_bound_ms=f_ms),
    }


def library_warp(torch, wk, coefs):
    """``F.grid_sample`` (bilinear, zeros outside) of a packed batch at
    the warp's sampling coordinates, normalised for align_corners=True:
    the library call beside the warp.  It leaves out the label
    renormalisation, and the flip is already folded into the coordinates;
    at the border it zeroes the missing corners where the warp clamps
    them."""
    import torch.nn.functional as F

    ys, xs = wk.sample_coords(coefs, SIZE, SIZE)
    grid = torch.stack([xs / (SIZE - 1) * 2 - 1, ys / (SIZE - 1) * 2 - 1],
                       -1)
    return lambda packed: F.grid_sample(
        packed.permute(0, 3, 1, 2), grid, mode="bilinear",
        padding_mode="zeros", align_corners=True)


def _losses(out_dir):
    """Per-step losses of a train-source run, from its metrics.jsonl."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return ([r["loss"] for r in recs if "loss" in r],
            [r["val_dice"] for r in recs if "val_dice" in r])


def phase_train(torch, wk, tk, fk, tmp):
    """Phase 6: full-width train-source through the CLI (TRAIN_RUNS) into
    run directories under ``tmp``, the final checkpoint served by predict,
    and make_train_step timed on the kernel and the plain path; returns
    ([warp launches, conv-moments launches] of the runs, {path:
    ms/step})."""
    from mcmda_tpu_torch import cli, weights
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.data import synthetic, volumes
    from mcmda_tpu_torch.utils import tree

    launches = [0, 0]
    runs = {}
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


def print_profile(label: str, m: dict) -> None:
    """One line from ``profiling.measure_step``'s dict."""
    print(f"{label} profile ({m['steps']} steps): "
          f"{m['host_ms_per_step']:.2f} ms/step on the host clock, device "
          f"busy {m['device_busy_ms_per_step']:.2f} ms/step, idle "
          f"{100 * m['idle_share']:.1f}%, {m['kernels_per_step']:.0f} "
          "kernels per step; top device time per step: "
          + "; ".join(f"{k[:60]} {t:.2f} ms" for k, t in m["top_kernels"]),
          flush=True)


def time_train_step(torch):
    """Median ms/step of make_train_step over TIMED_RUNS steps after 5
    warm-up steps, on the kernel path and the plain path (same data)."""
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.data import pipeline, synthetic, volumes
    from mcmda_tpu_torch.train import source
    from mcmda_tpu_torch.utils import profiling

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
        print_profile(f"train step {name}",
                      profiling.measure_step(step, state, data))
        del state
    return out


def phase_stem(torch, sk):
    """Phase 7: the thin stem through its kernel, held against the plain
    conv under autograd; returns the kernel's JSON fields."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    shape, k = (BATCH, SIZE, SIZE, 3), 16
    x = torch.randn(shape, device=DEVICE, generator=gen)
    w = torch.randn((3, 3, 3, k), device=DEVICE, generator=gen) \
        * math.sqrt(2.0 / 27)
    bn = {"scale": torch.rand(k, device=DEVICE, generator=gen) + 0.5,
          "bias": torch.randn(k, device=DEVICE, generator=gen) * 0.1}
    st = {"bn": {"mean": torch.zeros(k, device=DEVICE),
                 "var": torch.ones(k, device=DEVICE)}}
    r = torch.randn(shape[:3] + (k,), device=DEVICE, generator=gen)

    def run(use_kernel, input_grad=False):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        h, new = sk.stem_apply_cf({"conv": {"w": wg}, "bn": bn}, st, xg,
                                  train=True, momentum=0.99, eps=1e-5,
                                  use_kernel=use_kernel,
                                  input_grad=input_grad)
        dx, dw = torch.autograd.grad((h * r).sum(), (xg, wg),
                                     allow_unused=True)
        torch.cuda.synchronize()
        return h.detach(), new["bn"], dx, dw

    # the path: one train-mode stem, forward + weight gradient
    sk.LAUNCHES = 0
    h, new_bn, dx, dw = run(True)
    launches = sk.LAUNCHES
    if launches != 1:
        fail(f"thin stem: {launches} kernel launches, expected 1")
    # autograd of the plain conv gives dx whatever input_grad says
    rh, rbn, dx_p, rdw = run(False)
    y = sk.stem_conv_forward(x, w)
    torch.cuda.synchronize()
    ry = sk.stem_conv_nhwc_reference(x, w)
    err = (y - ry).abs().max().item()
    dw_rel = ((dw - rdw).abs().max() / rdw.abs().max()).item()
    _, _, dx_k, _ = run(True, input_grad=True)
    dx_rel = ((dx_k - dx_p).abs().max() / dx_p.abs().max()).item()
    ok = (torch.allclose(y, ry, rtol=RTOL, atol=ATOL)
          and torch.allclose(h, rh, rtol=RTOL, atol=ATOL)
          and all(torch.allclose(new_bn[s_], rbn[s_], rtol=RTOL, atol=ATOL)
                  for s_ in ("mean", "var")))
    w_oihw = w.permute(3, 2, 0, 1).contiguous()

    def lib(xx):
        return F.conv2d(xx.permute(0, 3, 1, 2), w_oihw, padding=1)

    sets = [(x.clone(),) for _ in range(COLD_SETS)]
    t_k = gpu_time_ms(lambda: sk.stem_conv_forward(x, w), torch)
    t_kc = gpu_time_cold_ms(lambda xx: sk.stem_conv_forward(xx, w), sets,
                            torch)
    t_p = gpu_time_ms(lambda: sk.stem_conv_nhwc_reference(x, w), torch)
    t_l = gpu_time_ms(lambda: lib(x), torch)
    t_lc = gpu_time_cold_ms(lib, sets, torch)
    del sets
    b_ms, b_by = bound(*conv_work(shape, k, 4, 4))
    print(f"thin stem x={list(shape)} k={k}: y max_abs_err={err:.3e}, dw "
          f"rel {dw_rel:.2e}, dx {'None' if dx is None else 'computed'} by "
          f"default, with input_grad rel {dx_rel:.2e}; kernel_ms={t_kc:.4f} "
          f"out of L2 ({t_k:.4f} on one buffer) plain_ms={t_p:.4f} "
          f"library_ms={t_lc:.4f} ({t_l:.4f}) bound_ms={b_ms:.4f} "
          f"({b_by}); launches {launches}"
          + ("; the one-buffer time is under the bound: the L2's, not "
             "device memory's" if t_k < b_ms else ""), flush=True)
    if not ok:
        fail(f"thin stem disagrees with plain: y max abs err {err}")
    if dx is not None or max(dw_rel, dx_rel) > GRAD_RTOL:
        fail(f"thin stem gradients: dx {dx is not None}, dw rel {dw_rel}, "
             f"dx rel {dx_rel}")
    # launches on two streams, each with its own weights, share no state:
    # every result is its own plain version's
    w2 = torch.randn(w.shape, device=DEVICE, generator=gen) * 0.5
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st_ in streams:
        st_.wait_stream(torch.cuda.current_stream())
    for _ in range(4):
        for st_, wt in zip(streams, (w, w2)):
            with torch.cuda.stream(st_):
                outs.append((wt, sk.stem_conv_forward(x, wt)))
    torch.cuda.synchronize()
    for wt, got in outs:
        if not torch.allclose(got, sk.stem_conv_nhwc_reference(x, wt),
                              rtol=RTOL, atol=ATOL):
            fail("thin stem: launches on two streams disturbed each other")
    # a width that is no multiple of 4 (the last thread of a row stores
    # fewer pixels, one by one) at ragged blocks
    xt = torch.randn((2, 37, 41, 3), device=DEVICE, generator=gen)
    yt = sk.stem_conv_forward(xt, w)
    torch.cuda.synchronize()
    t_err = (yt - sk.stem_conv_nhwc_reference(xt, w)).abs().max().item()
    print(f"thin stem: {len(outs)} launches on two streams each agree with "
          f"plain; x={list(xt.shape)} (W % 4 != 0) max_abs_err={t_err:.3e}",
          flush=True)
    if not torch.allclose(yt, sk.stem_conv_nhwc_reference(xt, w), rtol=RTOL,
                          atol=ATOL):
        fail(f"thin stem at W % 4 != 0: max abs err {t_err}")
    return dict(launches=launches, max_abs_err=max(err, t_err), ms=t_kc,
                one_buffer_ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=t_lc, library_one_buffer_ms=t_l)


def _adapt_metrics(out_dir):
    """Per-step d_loss, g_loss and d_acc of an adapt run."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {k: [r[k] for r in recs if "g_loss" in r]
            for k in ("d_loss", "g_loss", "d_acc")}


def phase_adapt(torch, wk, tk, tmp, source_dir):
    """Phase 8: full-width adapt through the CLI (ADAPT_RUNS) from the
    source run ``source_dir``; returns ([warp launches, conv-moments
    launches] of the runs, the kernel run's directory, {path: ms/step})."""
    from mcmda_tpu_torch import cli

    launches = [0, 0]
    runs = {}
    for name, sets, steps, n_warp, n_conv in ADAPT_RUNS:
        out = os.path.join(tmp, "adapt-" + name)
        argv = ["adapt", "--config", CONFIG, "--synthetic", "--source-ckpt",
                source_dir, "--out", out, "--device", DEVICE]
        for kv in [f"adapt.steps={steps}", "run.log_every=1", *sets]:
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
            fail(f"adapt {name} returned {rc}")
        m = _adapt_metrics(out)
        runs[name] = m
        with open(os.path.join(out, "selection.json")) as f:
            sel = json.load(f)
        print(f"adapt {name}: {steps} steps, cli wall {wall:.1f} s; "
              f"launches warp {got[0]}, conv_stats {got[1]}; d_loss first "
              f"{m['d_loss'][0]:.6f} last {m['d_loss'][-1]:.6f}; g_loss "
              f"first {m['g_loss'][0]:.6f} last {m['g_loss'][-1]:.6f}; "
              f"d_acc last {m['d_acc'][-1]:.4f}; selected step "
              f"{sel['best_step']}; files {sorted(os.listdir(out))}",
              flush=True)
        if got != (n_warp * steps, n_conv * steps):
            fail(f"adapt {name}: launches {got}, expected "
                 f"{(n_warp * steps, n_conv * steps)}")
        if any(len(v) != steps or not np.isfinite(v).all()
               for v in m.values()):
            fail(f"adapt {name}: metrics {m}")
        if not os.path.exists(os.path.join(
                out, f"step_{sel['best_step']:08d}.npz")):
            fail(f"adapt {name}: selected step {sel['best_step']} not "
                 "materialized")
    kernel_dir = os.path.join(tmp, "adapt-kernel")
    snaps = sorted(os.listdir(os.path.join(kernel_dir, "snapshots")))
    if snaps != ["step_00000010.png", "step_00000020.png"]:
        fail(f"adapt kernel: snapshots {snaps}")
    for sn in snaps:
        with open(os.path.join(kernel_dir, "snapshots", sn), "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                fail(f"adapt kernel: {sn} is not a PNG")
    a, b = runs["kernel-5a"], runs["kernel-5b"]
    print(f"adapt: two 5-step kernel runs "
          f"{'equal' if a == b else 'DIFFER'}; snapshots {snaps}",
          flush=True)
    if a["d_loss"] != b["d_loss"] or a["g_loss"] != b["g_loss"]:
        fail(f"seeded adapt runs differ: {a} vs {b}")
    for kern, plain, tol in (("kernel-f32", "plain-f32", STEP1_RTOL),
                             ("kernel-5a", "plain", STEP1_RTOL),
                             ("kernel-5a", "shipped", STEP1_RTOL)):
        k_m, p_m = runs[kern], runs[plain]
        rel = {k: abs(p_m[k][0] - k_m[k][0]) / abs(k_m[k][0])
               for k in ("d_loss", "g_loss")}
        print(f"adapt step-1 {kern} / {plain}: d_loss {k_m['d_loss'][0]!r}"
              f" / {p_m['d_loss'][0]!r} (rel {rel['d_loss']:.2e}), g_loss "
              f"{k_m['g_loss'][0]!r} / {p_m['g_loss'][0]!r} (rel "
              f"{rel['g_loss']:.2e}); held to {tol}", flush=True)
        if max(rel.values()) > tol:
            fail(f"adapt step-1 {kern}/{plain} rel diff {rel} > {tol}")
    return launches, kernel_dir, time_adapt_step(torch, source_dir)


def time_adapt_step(torch, source_dir):
    """Median ms/step of make_adapt_step over TIMED_RUNS steps after 5
    warm-up steps, on the kernel path and the plain path (same data and
    source checkpoint)."""
    from mcmda_tpu_torch import cli, weights
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.data import pipeline, synthetic, volumes
    from mcmda_tpu_torch.train import adapt
    from mcmda_tpu_torch.utils import profiling

    base = config_mod.load_config(CONFIG)
    data = {}
    for name, dom in (("src", "mri"), ("tgt", "ct")):
        vols, _ = synthetic.make_dataset(0, dom, 4, max(16, SIZE // 4), SIZE)
        data[name] = pipeline.to_device_arrays(
            volumes.volumes_to_slices(vols, context=3), device=DEVICE)
    params, bn = weights.restore_source(cli._resolve_ckpt(source_dir), base,
                                        DEVICE)
    out = {}
    for name, sets in (("kernel", ["segmenter.train_fused=pallas"]),
                       ("plain", ["data.warp=xla",
                                  "segmenter.train_fused=none"])):
        cfg = config_mod.load_config(CONFIG, sets)
        state = adapt.init_state(cfg.run.seed + 2, cfg, params, bn)
        step = adapt.make_adapt_step(cfg, sample_from_device=True)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(5 + TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, data, i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000)
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            fail(f"timed adapt {name} step: {metrics}")
        out[name] = statistics.median(times[5:])
        print(f"adapt step {name}: {out[name]:.2f} ms/step (median of "
              f"{TIMED_RUNS} after 5 warm-up; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)",
              flush=True)
        print_profile(f"adapt step {name}",
                      profiling.measure_step(step, state, data))
        del state
    return out


def phase_evaluate(torch, fk, tmp, run_dir, n_sites):
    """Phase 9: evaluate phase 8's kernel run on the fused path, then serve
    its selected checkpoint with predict; returns the fused conv's
    launches."""
    from mcmda_tpu_torch import cli
    from mcmda_tpu_torch.data import synthetic, volumes

    with open(os.path.join(run_dir, "selection.json")) as f:
        best = json.load(f)["best_step"]
    selected = os.path.join(run_dir, f"step_{best:08d}")
    sets = [a for kv in SETS for a in ("--set", kv)]
    args = cli.build_parser().parse_args(
        ["evaluate", "--config", CONFIG, "--synthetic", "--ckpt", run_dir,
         "--device", DEVICE, *sets])
    fk.LAUNCHES = 0
    t0 = time.perf_counter()
    agg = cli.cmd_evaluate(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_eval = fk.LAUNCHES
    # --synthetic-volumes 4 holds out one 64-slice target volume
    batches = -(-max(16, SIZE // 4) // BATCH)
    mean = agg["mean"]
    print(f"evaluate {os.path.basename(args.ckpt)}: cli wall {wall:.1f} s; "
          f"fused conv launches {n_eval} = {n_sites} x {batches} batches; "
          f"mean Dice {mean['dice']:.4f} ASSD {mean['assd']:.3f} HD95 "
          f"{mean['hd95']:.3f} misses {mean['assd_misses']}", flush=True)
    if args.ckpt != selected:
        fail(f"evaluate resolved {args.ckpt}, not the selected {selected}")
    if n_eval != n_sites * batches:
        fail(f"evaluate: {n_eval} fused conv launches, expected "
             f"{n_sites} x {batches}")
    if not all(math.isfinite(mean[k]) for k in ("dice", "assd", "hd95")):
        fail(f"evaluate: table not finite {mean}")
    vol, _ = synthetic.make_volume(np.random.default_rng(SEED + 1), "ct",
                                   depth=16, size=SIZE)
    vol_path = os.path.join(tmp, "in-adapt", "case2.npz")
    os.makedirs(os.path.dirname(vol_path))
    volumes.save_volume(vol_path, vol)
    pred_dir = os.path.join(tmp, "pred-adapt")
    fk.LAUNCHES = 0
    if cli._resolve_ckpt(run_dir) != selected:
        fail("predict would not serve the selected checkpoint")
    rc = cli.main(["predict", "--config", CONFIG, "--ckpt", run_dir,
                   "--input", vol_path, "--out", pred_dir, "--device",
                   DEVICE, *sets])
    n_pred = fk.LAUNCHES
    mask = volumes.load_volume_with_spacing(
        os.path.join(pred_dir, "case2_pred.npz"))[0]
    counts = np.bincount(mask.astype(np.int64).ravel(), minlength=5)
    print(f"predict {os.path.basename(selected)}: mask {list(mask.shape)} "
          f"classes {counts.tolist()}, fused conv launches {n_pred}",
          flush=True)
    if rc != 0 or mask.shape != (16, SIZE, SIZE) or \
            n_pred != -(-16 // BATCH) * n_sites:
        fail(f"predict of the adapted run: rc {rc}, mask {mask.shape}, "
             f"launches {n_pred}")
    return n_eval + n_pred


# phase 10: the --set overrides of the API path (beside the shipped config)
API_SETS = ["segmenter.train_fused=pallas", "run.use_pallas=true",
            "source.steps=10", "adapt.pretrain_steps=4", "adapt.steps=12",
            "run.ckpt_every=5", "run.log_every=1"]


def synchronous_feed(iterator, size=2, device="cuda"):
    """``pipeline.prefetch_to_device``'s queue order with nothing in
    flight: each batch is copied from pageable memory on the consumer's
    stream and waited for.  What the prefetching feed is held against."""
    import collections

    import torch

    queue = collections.deque()
    for batch in iterator:
        queue.append({k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                      .to(device) for k, v in batch.items()})
        torch.cuda.synchronize()
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def _npz_equal(a_path, b_path, weights, torch):
    """Whether two npz checkpoints hold the same keys and, leaf for leaf,
    the same bits."""
    a, b = weights.read_checkpoint(a_path), weights.read_checkpoint(b_path)
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype
        and torch.equal(torch.from_numpy(a[k]), torch.from_numpy(b[k]))
        for k in a)


def _states_equal(a, b, weights, torch):
    fa, fb = weights.flatten_state(a), weights.flatten_state(b)
    return set(fa) == set(fb) and all(
        torch.equal(torch.from_numpy(fa[k]), torch.from_numpy(fb[k]))
        for k in fa)


def counted_run(torch, kernels, total, label, fn, want):
    """Run ``fn`` with the launch counts of ``kernels`` (the warp, conv +
    moments and fused conv modules) at 0; print them, add them to
    ``total`` and hold them to ``want``.  Returns what ``fn`` returns."""
    torch.cuda.synchronize()
    for k in kernels:
        k.LAUNCHES = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = tuple(k.LAUNCHES for k in kernels)
    for i, n in enumerate(got):
        total[i] += n
    print(f"{label}: wall {wall:.1f} s; launches warp {got[0]}, "
          f"conv_stats {got[1]}, fused conv {got[2]}", flush=True)
    if got != tuple(want):
        fail(f"{label}: launches {got}, expected {tuple(want)}")
    return out


def phase_api(torch, wk, tk, fk, tmp, n_sites):
    """Phase 10: the library API at full width.  Device-resident:
    ``api.train_source -> api.adapt -> api.evaluate -> api.predict``, then
    the same seeds through the CLI (final checkpoints bitwise equal).
    Host-sampler (the cutoff set to 0): ``api.train_source`` and
    ``api.adapt`` through ``prefetch_to_device`` and again through
    ``synchronous_feed`` (losses and final states bitwise equal).  An
    ``out_dir=None`` run writes nothing.  Then the host-sampler steps are
    timed with both feeds.  Returns [warp, conv + moments, fused conv]
    launches of the API and CLI runs."""
    from mcmda_tpu_torch import api, cli, weights
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.data import pipeline, synthetic

    cfg = config_mod.load_config(CONFIG, API_SETS)
    n_src, n_pre, n_ad = (cfg.source.steps, cfg.adapt.pretrain_steps,
                          cfg.adapt.steps)
    # the phantoms --synthetic gives the CLI: the last target volume is the
    # test set
    depth = max(16, SIZE // 4)
    sv, sl = synthetic.make_dataset(0, "mri", 4, depth, SIZE)
    tv, tl = synthetic.make_dataset(0, "ct", 4, depth, SIZE)
    tgt_train, test_v, test_l = tv[:-1], tv[-1:], tl[-1:]
    total = [0, 0, 0]

    def counted(label, fn, want):
        return counted_run(torch, (wk, tk, fk), total, f"api {label}", fn,
                           want)

    def d(name):
        return os.path.join(tmp, "api-" + name)

    def check_runs(label, src_dir, ad_dir, src, ad):
        """Step counters, finite losses, selection.json and the pick."""
        if int(src.step) != n_src or int(ad.step) != n_pre + n_ad:
            fail(f"api {label}: steps {int(src.step)}, {int(ad.step)}")
        loss = _losses(src_dir)[0]
        m = _adapt_metrics(ad_dir)
        with open(os.path.join(ad_dir, "metrics.jsonl")) as f:
            d_loss = [r["d_loss"] for r in map(json.loads, f)
                      if "d_loss" in r]
        if len(loss) != n_src or len(d_loss) != n_pre + n_ad or \
                len(m["g_loss"]) != n_ad or not np.isfinite(
                    loss + d_loss + m["g_loss"]).all():
            fail(f"api {label}: losses {loss} {d_loss} {m['g_loss']}")
        with open(os.path.join(ad_dir, "selection.json")) as f:
            sel = json.load(f)
        if sel["signal"] != "class_ratio" or not os.path.exists(
                os.path.join(ad_dir, f"step_{sel['best_step']:08d}.npz")):
            fail(f"api {label}: selection {sel}, files "
                 f"{sorted(os.listdir(ad_dir))}")
        print(f"api {label}: loss first {loss[0]:.6f} last {loss[-1]:.6f}; "
              f"d_loss first {d_loss[0]:.6f} last {d_loss[-1]:.6f}; g_loss "
              f"last {m['g_loss'][-1]:.6f}; selected step "
              f"{sel['best_step']}; files {sorted(os.listdir(ad_dir))}",
              flush=True)
        return loss, d_loss, m["g_loss"], sel

    # 1. device-resident, through the API
    t1_want = (n_src, 15 * n_src, 0)
    ad_want = (n_pre + n_ad, 15 * (n_pre + n_ad), 0)
    src = counted("train_source", lambda: api.train_source(
        cfg, sv, sl, out_dir=d("src")), t1_want)
    ad = counted("adapt", lambda: api.adapt(
        cfg, src, sv, sl, tgt_train, out_dir=d("ad")), ad_want)
    api_run = check_runs("device-resident", d("src"), d("ad"), src, ad)
    batches = -(-depth // BATCH)
    table = counted("evaluate", lambda: api.evaluate(
        cfg, ad, test_v, test_l), (0, 0, n_sites * batches))
    masks = counted("predict", lambda: api.predict(
        cfg, ad, test_v), (0, 0, n_sites * batches))
    mean = table["mean"]
    print(f"api evaluate: mean Dice {mean['dice']:.4f} ASSD "
          f"{mean['assd']:.3f} HD95 {mean['hd95']:.3f} misses "
          f"{mean['assd_misses']}; predict: mask {list(masks[0].shape)} "
          f"{masks[0].dtype} classes "
          f"{np.bincount(masks[0].ravel(), minlength=5).tolist()}",
          flush=True)
    if "raw" not in table or not all(
            math.isfinite(mean[k]) for k in ("dice", "assd", "hd95")):
        fail(f"api evaluate: table {mean}, keys {sorted(table)}")
    if len(masks) != 1 or masks[0].shape != test_v[0].shape or \
            masks[0].dtype != np.uint8 or masks[0].max() > 4:
        fail(f"api predict: {masks[0].shape} {masks[0].dtype}")

    # 2. the same seeds through the CLI
    common = ["--config", CONFIG, "--synthetic", "--device", DEVICE,
              *(a for kv in API_SETS for a in ("--set", kv))]
    rcs = [counted("cli train-source", lambda: cli.main(
               ["train-source", *common, "--out", d("cli-src")]), t1_want),
           counted("cli adapt", lambda: cli.main(
               ["adapt", *common, "--source-ckpt", d("cli-src"), "--out",
                d("cli-ad")]), ad_want)]
    if any(rcs):
        fail(f"api: the CLI runs returned {rcs}")
    for a_dir, c_dir, last in ((d("src"), d("cli-src"), n_src),
                               (d("ad"), d("cli-ad"), n_pre + n_ad)):
        ckpts = sorted(n for n in os.listdir(a_dir) if n.endswith(".npz"))
        if f"step_{last:08d}.npz" not in ckpts or ckpts != sorted(
                n for n in os.listdir(c_dir) if n.endswith(".npz")):
            fail(f"api vs cli: checkpoints {ckpts} vs {os.listdir(c_dir)}")
        for n in ckpts:
            if not _npz_equal(os.path.join(a_dir, n), os.path.join(c_dir, n),
                              weights, torch):
                fail(f"api vs cli: {n} of {os.path.basename(a_dir)} differs")
        print(f"api vs cli {os.path.basename(a_dir)}: {ckpts} bitwise "
              "equal", flush=True)

    # 3. host-sampler: the prefetching feed against a synchronous one
    real_cutoff, real_feed = api._ON_DEVICE_BYTES, pipeline.prefetch_to_device
    fed = []

    def counting(feed_fn):
        def feed(iterator, size=2, device="cuda"):
            for batch in feed_fn(iterator, size, device):
                fed.append(sorted(batch))
                yield batch
        return feed

    host = {}
    api._ON_DEVICE_BYTES = 0
    try:
        for name, feed_fn in (("prefetch", real_feed),
                              ("synchronous", synchronous_feed)):
            pipeline.prefetch_to_device = counting(feed_fn)
            fed.clear()
            h_src = counted(f"host-sampler {name} train_source",
                            lambda: api.train_source(
                                cfg, sv, sl, out_dir=d(f"host-{name}-src")),
                            t1_want)
            h_ad = counted(f"host-sampler {name} adapt", lambda: api.adapt(
                cfg, h_src, sv, sl, tgt_train, out_dir=d(f"host-{name}-ad")),
                ad_want)
            want_fed = [["image", "label"]] * n_src \
                + [["src_image", "tgt_image"]] * (n_pre + n_ad)
            if fed != want_fed:
                fail(f"api host-sampler {name}: the feed handed over "
                     f"{len(fed)} batches {fed[:1]}..{fed[-1:]}, expected "
                     f"{len(want_fed)}")
            host[name] = (h_src, h_ad, check_runs(
                f"host-sampler {name}", d(f"host-{name}-src"),
                d(f"host-{name}-ad"), h_src, h_ad))
    finally:
        api._ON_DEVICE_BYTES = real_cutoff
        pipeline.prefetch_to_device = real_feed
    (p_src, p_ad, p_run), (s_src, s_ad, s_run) = (host["prefetch"],
                                                  host["synchronous"])
    same = (p_run == s_run and _states_equal(p_src, s_src, weights, torch)
            and _states_equal(p_ad, s_ad, weights, torch))
    print(f"api host-sampler: {n_src} + {n_pre + n_ad} batches through "
          "prefetch_to_device (pinned ring, side stream); losses, "
          "selection and final states against the synchronous feed "
          f"{'bitwise equal' if same else 'DIFFER'}; against the "
          "device-resident run the losses "
          f"{'differ (other batches)' if p_run[0] != api_run[0] else 'ARE EQUAL'}",
          flush=True)
    if not same:
        fail(f"api host-sampler: prefetch {p_run} vs synchronous {s_run}")
    if p_run[0] == api_run[0]:
        fail("api host-sampler: the run repeated the device-resident losses")

    # 4. out_dir=None writes nothing
    empty = d("nothing")
    os.makedirs(empty)
    before = sorted(os.listdir(tmp))
    cwd = os.getcwd()
    os.chdir(empty)
    try:
        none_state = counted("train_source out_dir=None",
                             lambda: api.train_source(cfg, sv, sl, steps=2),
                             (2, 30, 0))
    finally:
        os.chdir(cwd)
    print(f"api out_dir=None: step {int(none_state.step)}, files written "
          f"{os.listdir(empty)}", flush=True)
    if int(none_state.step) != 2 or os.listdir(empty) or \
            sorted(os.listdir(tmp)) != before:
        fail(f"api out_dir=None wrote files: {os.listdir(empty)}, "
             f"{sorted(os.listdir(tmp))}")

    # 5. the host-sampler steps, timed with both feeds
    time_host_steps(torch, cfg, src, sv, sl, tgt_train)
    return total


def time_host_steps(torch, cfg, src, sv, sl, tgt_train):
    """ms/step (median of TIMED_RUNS after 5 warm-up, host clock around
    ``next(feed)`` + step + synchronise) of the host-sampler T1 and adapt
    steps with the prefetching feed and with the synchronous feed, in the
    order prefetch, synchronous, synchronous, prefetch; then
    ``measure_step`` of each feed."""
    from mcmda_tpu_torch.data import pipeline, volumes
    from mcmda_tpu_torch.train import adapt, drivers, source
    from mcmda_tpu_torch.utils import profiling

    src_ds = volumes.volumes_to_slices(sv, sl, context=3, drop_empty=True)
    tgt_ds = volumes.volumes_to_slices(tgt_train, context=3)

    def t1_stream():
        return iter(pipeline.BatchSampler(src_ds, BATCH, seed=1,
                                          num_classes=cfg.data.num_classes))

    def adapt_stream():
        return ({"src_image": a["image"], "tgt_image": b["image"]}
                for a, b in zip(pipeline.BatchSampler(src_ds, BATCH, seed=3),
                                pipeline.BatchSampler(tgt_ds, BATCH, seed=4)))

    feeds = {"prefetch": lambda s: drivers.feed(s, DEVICE),
             "synchronous": lambda s: synchronous_feed(s, 2, DEVICE)}
    for label, step, state, stream in (
            ("T1", drivers.wrap_dp(cfg, source.make_train_step,
                                   device=DEVICE)[0],
             src, t1_stream),
            ("adapt", drivers.wrap_dp(cfg, adapt.make_adapt_step,
                                      device=DEVICE)[0],
             adapt.init_state(cfg.run.seed + 2, cfg, src.params,
                              src.bn_state), adapt_stream)):
        for name in ("prefetch", "synchronous", "synchronous", "prefetch"):
            feed = feeds[name](stream())
            st, times = state, []
            for i in range(5 + TIMED_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, metrics = step(st, next(feed), i)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1000)
            if not all(math.isfinite(float(v)) for v in metrics.values()):
                fail(f"timed host-sampler {label} step: {metrics}")
            print(f"host-sampler {label} step, {name} feed: "
                  f"{statistics.median(times[5:]):.2f} ms/step (median of "
                  f"{TIMED_RUNS} after 5 warm-up)", flush=True)
            print_profile(f"host-sampler {label} step, {name} feed",
                          profiling.measure_step(step, st, feed))


# phase 11: the quality scripts at toy lengths, at full width.  The sweep
# runs 2 seeds of QUALITY_ADAPT adapt steps from one QUALITY_SOURCE-step
# source run, a probe every 10 steps, on 2 volumes of 16 slices; the
# benchmark one direction through the CLI; the e2e example its plain paths.
QUALITY_SOURCE, QUALITY_ADAPT, QUALITY_SEEDS = 20, 40, 2
SWEEP_ARGS = ["--direction", "mri2ct", "--config", CONFIG, "--set",
              "segmenter.train_fused=pallas", "--volumes", "2", "--depth",
              "16", "--source-steps", str(QUALITY_SOURCE), "--adapt-steps",
              str(QUALITY_ADAPT), "--eval-every", "10", "--device", DEVICE]
BENCH_STEPS = 10
BENCH_SETS = ["segmenter.train_fused=pallas", "run.use_pallas=true",
              f"source.steps={BENCH_STEPS}", f"adapt.steps={BENCH_STEPS}",
              "run.ckpt_every=0"]
E2E_ARGS = ["--source-steps", "30", "--pretrain-steps", "10",
            "--adapt-steps", "30"]
# the reference artifact the sweep's keys are held to; the reference script
# writes its config-policy pick (selected_cfg) since, and the port adds the
# card and the precision pins
SWEEP_REFERENCE = os.path.join(ROOT, "results", "mri2ct_seed_sweep_r5.json")
SWEEP_NEWER = ({"selected_cfg", "card", "settings"},
               {"selected_cfg", "selected_cfg_step"})


def phase_quality(torch, wk, tk, fk, tmp, n_sites):
    """Phase 11: the seed-sweep twin (keys against the reference artifact,
    a ``--merge`` rerun of seed 1 bitwise), the synthetic-benchmark twin for
    mri2ct (four commands, two tables) and the e2e example twin on the
    card.  Returns [warp, conv + moments, fused conv] launches."""
    import contextlib
    import importlib.util
    import io
    import shutil
    from mcmda_tpu_torch.scripts import seed_sweep, synthetic_benchmark

    total = [0, 0, 0]
    kernels = (wk, tk, fk)

    # seed sweep: 1 warp + 15 conv + moments per T1 and adapt step; the
    # probes run the plain eval forward
    path = os.path.join(tmp, "sweep.json")
    steps = QUALITY_SOURCE + QUALITY_SEEDS * QUALITY_ADAPT
    art = counted_run(torch, kernels, total, "quality seed sweep",
                      lambda: seed_sweep.main([*SWEEP_ARGS, "--seeds",
                                               str(QUALITY_SEEDS), "--out",
                                               path]),
                      (steps, 15 * steps, 0))
    with open(SWEEP_REFERENCE) as f:
        ref = json.load(f)
    top, seed_keys = SWEEP_NEWER
    rows = art["per_seed"]
    if set(art) != set(ref) | top or any(
            set(r) != set(ref["per_seed"][0]) | seed_keys for r in rows):
        fail(f"seed sweep keys {sorted(art)} / {sorted(rows[0])} are not "
             "the reference artifact's")
    ticks = [[c["step"] for c in cv] for cv in art["curves"].values()]
    if ticks != [list(range(10, QUALITY_ADAPT + 1, 10))] * QUALITY_SEEDS:
        fail(f"seed sweep probe steps {ticks}")
    values = [art["no_adapt"]] + [r[k] for r in rows for k in
                                  ("final", "selected_cr_ent", "oracle")]
    if not all(0.0 <= v <= 1.0 for v in values):
        fail(f"seed sweep Dice out of range: {values}")
    print(f"quality seed sweep: no-adapt {art['no_adapt']}, final "
          f"{art['final']}, cr_ent {art['selected_cr_ent']}, oracle "
          f"{art['oracle']}; card {art['card']!r}, pins {art['settings']}",
          flush=True)
    merged = os.path.join(tmp, "sweep-merge.json")
    shutil.copy(path, merged)
    again = counted_run(torch, kernels, total, "quality seed sweep --merge",
                        lambda: seed_sweep.main([*SWEEP_ARGS, "--seeds", "1",
                                                 "--first-seed", "1",
                                                 "--merge", "--out",
                                                 merged]),
                        (QUALITY_SOURCE + QUALITY_ADAPT,
                         15 * (QUALITY_SOURCE + QUALITY_ADAPT), 0))
    a, b = json.loads(json.dumps(art)), json.loads(json.dumps(again))
    same = (a["per_seed"] == b["per_seed"], a["curves"] == b["curves"])
    print(f"quality seed sweep --merge: seed 0 kept, seed 1 rerun; rows "
          f"equal {same[0]}, curves equal {same[1]}", flush=True)
    if not all(same):
        fail("the --merge rerun did not reproduce the sweep bitwise")

    # synthetic benchmark, one direction: train-source, evaluate
    # --source-only, adapt, evaluate; each evaluate runs the fused conv at
    # every call site of the held-out 64-slice volume's 8 forward batches
    res = os.path.join(tmp, "bench-results")
    batches = -(-max(16, SIZE // 4) // BATCH)
    counted_run(torch, kernels, total, "quality synthetic benchmark mri2ct",
                lambda: synthetic_benchmark.main(
                    ["--direction", "mri2ct", "--runs",
                     os.path.join(tmp, "bench-runs"), "--results-dir", res,
                     *(a for kv in BENCH_SETS for a in ("--set", kv))]),
                (2 * BENCH_STEPS, 30 * BENCH_STEPS, 2 * n_sites * batches))
    tables = sorted(os.listdir(res))
    if tables != [f"torch_synthetic_mri2ct_{k}.json"
                  for k in ("adapted", "no_adapt")]:
        fail(f"synthetic benchmark wrote {tables}")
    for name in tables:
        with open(os.path.join(res, name)) as f:
            mean = json.load(f)["mean"]
        if not all(math.isfinite(mean[k]) for k in ("dice", "assd")):
            fail(f"synthetic benchmark {name}: {mean}")

    # the e2e example on the card: the plain paths, as the JAX package's
    spec = importlib.util.spec_from_file_location(
        "port_e2e", os.path.join(ROOT, "mcmda_tpu_torch", "examples",
                                 "synthetic_e2e.py"))
    e2e = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(e2e)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = counted_run(torch, kernels, total, "quality e2e example",
                         lambda: e2e.main(E2E_ARGS), (0, 0, 0))
    lines = [ln for ln in log.getvalue().splitlines()
             if ln.startswith(("summary:", "E2E RESULT:", "quality e2e"))]
    print("quality e2e example: " + " | ".join(lines) + f"; exit {rc}",
          flush=True)
    if rc not in (0, 1) or len(lines) != 3:
        fail(f"e2e example: exit {rc}, lines {lines}")
    return total


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
        from mcmda_tpu_torch.kernels import thin_conv as sk
        from mcmda_tpu_torch.kernels import train_conv as tk
        from mcmda_tpu_torch.kernels import warp as wk
        from mcmda_tpu_torch.utils import device as device_mod
    except ImportError as e:
        fail(f"run from the root of a checkout ({e})")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    device_mod.resolve(DEVICE)
    kind = torch.cuda.get_device_name(0)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"device: {kind}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; pins "
          f"{json.dumps(device_mod.settings())}", flush=True)
    if device_mod.settings()["tf32"]:
        fail("TF32 is not pinned off")

    # 2. build
    t0 = time.perf_counter()
    lib = build.build()
    with open(os.path.join(os.path.dirname(lib), "nvcc.log")) as f:
        report = ptxas_report(f.read())
    ring = {(dt, k): build.load().mcmda_conv_smem_bytes(bf, 1 << 20, k)
            for dt, bf in (("f32", 0), ("bf16", 1)) for k in (16, 32, 64, 128)}
    print(f"build: {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s; ptxas per instantiation: "
          + " | ".join(f"{name} {regs} registers, {spill} B spilled, "
                       f"{smem} B static shared" for name, regs, spill, smem
                       in report)
          + "; conv ring (dynamic shared memory) by x dtype and tile "
          "width: " + ", ".join(f"{dt} {k}: {b} B" for (dt, k), b
                                in ring.items()), flush=True)
    spilled = [name for name, _, spill, _ in report if spill]
    if spilled:
        fail(f"kernels spill registers: {spilled}")

    cfg = config_mod.eval_view(config_mod.load_config(CONFIG, SETS))

    # 3. kernel vs plain
    n_sites, fused = phase_kernel(cfg.segmenter, torch, fk)

    # 4. full-width predict
    launches = phase_predict(cfg, torch, fk, n_sites)

    # 5. train kernels vs plain
    train_cfg = config_mod.load_config(CONFIG)
    fields = phase_train_kernels(train_cfg, torch, wk, tk, pipeline)

    with tempfile.TemporaryDirectory() as tmp:
        # 6. full-width train-source
        source_dir = os.path.join(tmp, "source")
        (warp_launches, conv_launches), step_ms = phase_train(
            torch, wk, tk, fk, source_dir)
        print(f"train step ms: kernel path {step_ms['kernel']:.2f}, plain "
              f"path {step_ms['plain']:.2f}", flush=True)

        # 7. the thin stem
        stem = phase_stem(torch, sk)

        # 8. full-width adapt from phase 6's kernel run
        (w_n, c_n), adapt_dir, adapt_ms = phase_adapt(
            torch, wk, tk, tmp, os.path.join(source_dir, "kernel"))
        warp_launches += w_n
        conv_launches += c_n
        print(f"adapt step ms: kernel path {adapt_ms['kernel']:.2f}, plain "
              f"path {adapt_ms['plain']:.2f}", flush=True)

        # 9. evaluate the adapted run on the fused path
        launches += phase_evaluate(torch, fk, tmp, adapt_dir, n_sites)

        # 10. the library API, device-resident and host-sampler feeds
        api_w, api_c, api_f = phase_api(torch, wk, tk, fk, tmp, n_sites)
        warp_launches += api_w
        conv_launches += api_c
        launches += api_f

        # 11. the quality scripts at toy lengths
        q_w, q_c, q_f = phase_quality(torch, wk, tk, fk, tmp, n_sites)
        warp_launches += q_w
        conv_launches += q_c
        launches += q_f

    print(json.dumps({"kernels": [{
        "name": "conv_bn_act",
        "route": "cuda",
        "source": "mcmda_tpu_torch/kernels/csrc/fused_conv.cu",
        "replaces": "mcmda_tpu/kernels/fused_conv.py:101",
        "launches": launches,
        **fused,
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
    }, {
        "name": "stem_conv",
        "route": "cuda",
        "source": "mcmda_tpu_torch/kernels/csrc/thin_conv.cu",
        "replaces": "mcmda_tpu/kernels/thin_conv.py:68",
        **stem,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
