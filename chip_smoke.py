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
   precision, and source-only in f32.  Checks the masks, the kernel's
   launches (the volume is one CUDA graph: the wrapper runs once per fused
   call site for the warm-up batch and for each captured batch, the replay
   runs each batch's, read from a trace), and that the masks match the
   same run on the kernel's plain version on the card (see RUNS); times
   both paths.
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
   (step-1 losses of each kernel/plain pair within STEP1_RTOL); the
   step-1 pair over STEP1_SEEDS step seeds from one state, f32 and bf16
   source features, and bf16 with both paths on the plain warp, beside a
   precision control (see STEP1_SEEDS).
   Checks the launches per step, finite losses, selection.json, the
   materialized selected checkpoint and the snapshot PNGs; times
   ``make_adapt_step`` on both paths.
9. evaluate: ``python -m mcmda_tpu_torch evaluate`` of phase 8's kernel run
   on the fused path (run.use_pallas): it resolves selection.json, the
   fused conv's launches are counted as in phase 4, and the Dice / ASSD
   table is finite; ``predict`` serves the same selected checkpoint.
10. api: ``api.train_source -> api.adapt -> api.evaluate -> api.predict``
   at full width (see API_SETS) on the device-resident feed (step
   counters, finite losses, selection.json and the materialized pick, a
   finite table, uint8 masks, launches per step and per forward batch);
   the same seeds through the CLI (every checkpoint bitwise equal); the
   host-sampler feed (``api._ON_DEVICE_BYTES = 0``, a CUDA graph of one
   step per batch) through ``prefetch_to_device`` and through a
   synchronous feed of the same sampler stream (losses and final states
   bitwise equal); an ``out_dir=None`` run that writes nothing; ms/step
   and ``profiling.measure_step`` of the host-sampler steps with both
   feeds.
11. quality: the seed-sweep twin (``mcmda_tpu_torch/scripts/seed_sweep.py``)
   at full width on 2 volumes of 16 slices, 20 source and 2 x 40 adapt
   steps, a probe every 10 (artifact keys against the reference's
   ``results/mri2ct_seed_sweep_r5.json``, a ``--first-seed 1 --merge``
   rerun bitwise equal); the synthetic-benchmark twin for mri2ct at 10 + 10
   steps with ``run.use_pallas`` on ``evaluate`` (traced); the e2e example
   twin on the card (its plain paths: no kernel launch).  Launches held to
   1 warp + 15 conv + moments per training step and 19 fused convs per
   forward batch, as the graphs launch them.
12. dp: data parallelism on the one card.  (a) two spawned ranks on
   cuda:0 over gloo (NCCL refuses two ranks on one GPU), 8 slices each:
   one T1 step and one adapt step per ``d_acc_cap`` (1.0, 0.5) at full
   width on the kernel path, from the same state with injected draws,
   against one process on the 16 slices (losses, ``d_acc``, parameters,
   BN state; the ranks' states bitwise equal) and beside the one process
   on the batch reordered (how far summation order alone moves it); the
   ranks' step times, gloo through the host.  (b) ``train-source`` and
   ``adapt --multihost --gloo`` through the CLI on two ranks: rank 0
   writes the checkpoints, metrics, snapshots and ``selection.json``, rank
   1 (a run directory of its own) nothing, both print the same metrics.
   (c) a one-rank NCCL world: its T1 step bitwise the step without a
   group; two NCCL ranks on cuda:0 (the error printed); ``--dp`` beyond
   the GPUs refused.
13. ct2mri: the reverse direction with configs/ct2mri.json as shipped
   (plug depth rm2, critic throttle 0.9, probe every 100 steps capped to a
   quarter of a short run, flip TTA) and the kernels asked for, at full
   width through the CLI (see CT_ADAPT_RUNS).  (a) train-source on CT; (b)
   adapt from it: the kernel path for 30 steps (probe ticks, selection,
   the materialized pick, snapshots), two 5-step kernel runs (bitwise
   equal losses), step-1 kernel/plain pairs in f32 and the shipped bf16
   source forward (within STEP1_RTOL), launches per step;
   ``make_adapt_step`` timed at rm2 on both paths and at rm3 from the same
   source state (ms/step, ``measure_step``), and one step per depth with
   the conv + moments weight gradients counted (CT_WGRADS: none for the
   frozen higher layers at rm2) and, at rm2, the step's host
   synchronisations (none: the throttle decides on the device); (c) the
   EMA variant (``adapt.dam_ema=0.5``) selects a weight variant; (d)
   ``evaluate`` of (b)'s run on the fused path (selection.json, flip TTA at
   batch 16, bf16; 19 launches per forward batch) and ``predict`` of its
   pick against the plain path (at least 99.5% of voxels) and an f64
   fused conv (EXACT_SLACK); (e) the plug-depth ablation twin at toy
   lengths, all three depths.
14. scan: the compiled multi-step dispatch, CUDA graphs of the
   device-resident steps (``loop.scanned_step``; the CLI / API runs of
   phases 6-13 take it too, at their own ``pick_inner``).  (d)
   ``train-source`` through the CLI at 25 steps per call (log steps by the
   JAX package's rule), the source of (b); (a) T1 (configs/mri2ct.json,
   kernel path) and (b) adapt (mri2ct at rm3; ct2mri at rm2 from a critic
   trained ahead, so that its 0.9 throttle holds steps; ct2mri with
   ``adapt.dam_ema=0.5``): 50 steps on the graph against 50 eager steps
   with the same seeds, every state tensor and the last metrics
   ``torch.equal``, the graph's replays counted on the device; each
   capture under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation);
   (c) T1 and adapt at rm3 eager and on the graph: ms/step (median of 3
   calls of 50 steps after a warm-up call), ``measure_step`` (device busy
   time, idle share, host launch calls per step), capture time and graph
   pool; (d) ``adapt`` through the CLI on the graph (log and probe steps,
   selection.json, the pick) and a train-source run stopped by SIGTERM
   (sent to this process once its step-50 checkpoint exists) and resumed,
   bitwise the uninterrupted run; (f) a one-rank NCCL group's step
   captured against its eager path.
15. graphs: the last eager dispatch on CUDA graphs, at full width
   (configs/mri2ct.json, kernel path), each against its eager twin
   (``eager_dispatch``) and timed both ways (host clock, median after a
   warm-up, in turns; ``measure_step``: device busy, idle share, host
   launch calls).  (a) the host-sampler feed (``api._ON_DEVICE_BYTES =
   0``) through the API, T1 then adapt at rm3 (critic pretrain and main
   step), HOST_STEPS each: every state tensor ``torch.equal``, every
   step's metrics and ``selection.json`` equal, the ``feed path:`` lines;
   ms/step of each step, capture and pool; (b) serving: ``predict_volume``
   as one graph against its batch loop, masks ``np.array_equal``, for
   phase 4's three cases (bf16, flip TTA at batch 16, f32): ms per
   64-slice volume, the CLI ``predict`` wall both ways, capture and pool
   growth; (c) one selection tick (``make_select_bundle``) on the graph
   against eager: fractions and entropy ``torch.equal``, ms per tick; (d)
   the seed sweep at toy length with ``adapt.dam_ema=0.5`` (the live,
   flip-TTA and in-state EMA probes): curves and rows equal; (e) a
   one-rank NCCL group's host-sampler graph, NCCL_STEPS steps, bitwise one
   process; (f) a capture that syncs with the host and a fed batch of
   another shape raise.

Launch counts: each kernel's wrapper counts its launches on the host, a
launch that runs at once and one that a CUDA graph capture records alike;
a graph's replays run the recorded kernels with no wrapper call.  A
training run's wrappers so launch 2 steps' kernels per graph
(``on_graph``: the first call's eager step and the capture), which phases
6-13 hold; a serving run's fused conv launches, per volume graph, its
warm-up batch and its captured batches (``served``).  Phase 14 traces its
CLI runs and its graphs' calls, and phases 4, 9, 10, 11 and 13 their
serving runs, with ``torch.profiler`` (``traced_launches``), and hold what
the replays ran (the kernels whose launch, by CUPTI correlation id, is a
graph launch) to the launches the graph recorded, as far as a trace,
which may lack records, can show them; the kernels line counts the
wrappers' launches everywhere plus the replays the traces show.

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

import contextlib
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
# phase 8 also reads the adapt step-1 kernel/plain pair over STEP1_SEEDS
# step seeds (batch and augmentation draws) from one state.  With f32
# source features it read 4.0e-6 to 1.2e-4 on an H100, held to
# SPREAD_F32_RTOL; the control, the plain path with bf16 against f32
# source features (a change of precision, not of summation order), read
# 7.9e-4 to 3.7e-3 and must exceed SPREAD_F32_RTOL at every seed.  With
# the shipped bf16 source features the pair read 6.9e-4 to 1.7e-3, the
# size of the control itself: ulp-level differences of the inputs (the
# flip folded into the warp) and of the conv + moments kernel's sums flip
# bf16 roundings, so no limit on the bf16 pair tells the kernel from a
# precision change; it is held to SPREAD_BF16_RTOL, 1.5x its largest
# reading, against gross faults only.  The pair with teeth runs both
# paths on the plain warp (``data.warp=xla``): the augmented batch and
# the bf16 source features (no conv + moments call) are then identical,
# only the kernel's summation order in the f32 target forward differs,
# and it is held to SPREAD_F32_RTOL with bf16 source features too: it read
# 2.0e-7 to 1.1e-6 on an H100, the control 7.9e-4 to 3.7e-3.
STEP1_SEEDS = 8
SPREAD_F32_RTOL = 5e-4
SPREAD_BF16_RTOL = 2.5e-3
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

# phase 12: data parallelism.  The card's machine has one GPU, and NCCL
# refuses two ranks of one communicator on one GPU, so (a) and (b) run two
# ranks on cuda:0 over gloo (every all-reduce goes through the host: these
# are not multi-GPU scaling figures) and (c) a one-rank NCCL world.  Each
# rank of (a) steps its BATCH of the DP_RANKS * BATCH slices that one
# process steps at once, from the same state with the same injected draws.
# The adapt steps run the source forward in f32 (F32_SRC): d_acc, a count
# of critic patch decisions, is held to DP_DACC_RTOL, and the shipped bf16
# source forward rounds at other places when the batch is split.
DP_RANKS = 2
DP_TIMED = 3
DP_CAPS = (1.0, 0.5)
DP_SETS = ["segmenter.train_fused=pallas", F32_SRC]
# the reference's own tolerances (tests/test_parallel.py): segmenter and
# DAM parameters after one step, the critic and its optimizer state.
# Adam's first step moves each parameter by about lr * sign(g), so where
# |g| sits at rounding level the step moves it by up to 2 lr = 2e-3 (T1)
# whatever the batch split: on an H100 one process moved its own T1
# parameters that far when only the order of the batch changed (PERF.md,
# section 6).  The T1 parameters are held to DP_PARAM_ATOL where the
# gradient's sign is determined (|g| above twice the largest
# DP-vs-one-process difference of g in its tensor), and the gradients,
# read from Adam's first moment, to DP_GRAD_RTOL of the largest |g|: a
# sync or scale fault moves them by O(1) of it, while summation order
# moved one process's own by up to 3.5e-3 of it (BN over near-constant
# channels, E[x^2] - E[x]^2).
DP_PARAM_ATOL = 5e-4
DP_CRITIC_ATOL = 2e-3
DP_BN_ATOL = 1e-5
DP_DACC_RTOL = 1e-5
DP_GRAD_RTOL = 1e-2
DP_TIMEOUT = 300
DP_CLI_STEPS = 4



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


def exact_conv_bn_act(x, w, scale, bias, *, dilation=1, activation="relu",
                      residual=None):
    """The fused conv's plain version in f64, rounded to f32: the answer
    that both f32 versions approximate, each with its own summation
    order."""
    import torch
    from mcmda_tpu_torch.kernels import fused_conv as fk
    from mcmda_tpu_torch.ops import layers

    f64 = torch.float64
    y = layers.conv_apply({"w": w}, x, dilation=dilation, compute_dtype=f64)
    y = y * scale.to(f64) + bias.to(f64)
    if residual is not None:
        y = y + residual.to(f64)
    return fk._activate(y, activation).float()


def predict_exact(cli, fk, argv):
    """``predict`` (``argv``) on the fused path with every fused conv in
    f64 (``exact_conv_bn_act``)."""
    real = fk.conv_bn_act_reference
    fk.conv_bn_act_reference = exact_conv_bn_act
    try:
        cli.cmd_predict(cli.build_parser().parse_args(argv), use_kernel=False)
    finally:
        fk.conv_bn_act_reference = real


def phase_predict(cfg, torch, fk, n_sites):
    """Phase 4: full-width predict through the CLI (see RUNS); returns the
    kernel launches of the runs."""
    from mcmda_tpu_torch import cli
    from mcmda_tpu_torch.data import volumes

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
            total = [0]
            rc = traced_run(torch, (fk,), total, f"predict {name}",
                            lambda: cli.main(argv + ["--out",
                                                     outs["kernel"]]),
                            *((n,) for n in served(n_sites, batches)))
            launches += total[0]
            if rc != 0:
                fail(f"predict {name} returned {rc}")
            args = cli.build_parser().parse_args(argv + ["--out",
                                                         outs["plain"]])
            cli.cmd_predict(args, use_kernel=False)
            predict_exact(cli, fk, argv + ["--out", outs["exact"]])
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
                  f"{counts.tolist()}; voxel agreement kernel/plain {kp:.6f}"
                  f" ({int(round((1 - kp) * mask.size))} differ), "
                  f"kernel/exact {ke:.6f}, plain/exact {pe:.6f}; "
                  f"predict_volume kernel {t_k:.1f} ms/volume "
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
        if got != on_graph((n_warp, n_conv)):
            fail(f"train-source {name}: launches {got}, expected "
                 f"{on_graph((n_warp, n_conv))}")
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
          f"kernels and {m['host_launches_per_step']:.2f} host launch "
          "calls per step; top device time per step: "
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
              f"{m['d_loss'][0]:.6f} last "
              f"{m['d_loss'][-1]:.6f}; g_loss first {m['g_loss'][0]:.6f} "
              f"last {m['g_loss'][-1]:.6f}; d_acc last "
              f"{m['d_acc'][-1]:.4f}; selected step {sel['best_step']}; "
              f"files {sorted(os.listdir(out))}", flush=True)
        if got != on_graph((n_warp, n_conv)):
            fail(f"adapt {name}: launches {got}, expected "
                 f"{on_graph((n_warp, n_conv))}")
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
    setup = adapt_setup(source_dir)
    step1_spread(torch, setup)
    return launches, kernel_dir, time_adapt_step(torch, source_dir,
                                                 setup=setup)


def step1_spread(torch, setup):
    """Phase 8: one adapt step of the kernel and the plain path from one
    state (``adapt_setup``'s) with each of STEP1_SEEDS step seeds, so with
    as many batch and augmentation draws, with the shipped bf16 source
    features and with f32 ones.  Per seed the larger relative difference
    in d_loss and g_loss: the kernel/plain pairs held to SPREAD_F32_RTOL
    (f32, and bf16 with both paths on the plain warp) and SPREAD_BF16_RTOL
    (bf16 as shipped), and the control, the plain path
    with bf16 against f32 source features (the precision of the features,
    not the summation order, changed), which must exceed SPREAD_F32_RTOL
    at every seed (see STEP1_SEEDS)."""
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.train import adapt

    data, params, bn = setup
    loss = {}
    runs = [(name, sets, feats, extra) for name, sets in ADAPT_PATHS
            for feats, extra in (("bf16", []), ("f32", [F32_SRC]))]
    runs.append(("kernel-xla", ["data.warp=xla", *ADAPT_PATHS[0][1]],
                 "bf16", []))
    for name, sets, feats, extra in runs:
        cfg = config_mod.load_config(CONFIG, [*sets, *extra])
        state = adapt.init_state(cfg.run.seed + 2, cfg, params, bn)
        step = adapt.make_adapt_step(cfg, sample_from_device=True)
        loss[name, feats] = [
            {k: float(v) for k, v in step(state, data, seed)[1].items()}
            for seed in range(STEP1_SEEDS)]

    def rel(a, b):
        return [max(abs(x[k] - y[k]) / abs(y[k]) for k in ("d_loss",
                                                           "g_loss"))
                for x, y in zip(loss[a], loss[b])]

    pair = rel(("kernel", "bf16"), ("plain", "bf16"))
    pair32 = rel(("kernel", "f32"), ("plain", "f32"))
    pair_xla = rel(("kernel-xla", "bf16"), ("plain", "bf16"))
    control = rel(("plain", "bf16"), ("plain", "f32"))
    print(f"adapt step-1 over {STEP1_SEEDS} step seeds, kernel / plain, "
          f"largest of d_loss and g_loss rel: f32 source "
          f"{[f'{r:.2e}' for r in pair32]} (held to {SPREAD_F32_RTOL}); "
          f"bf16 source {[f'{r:.2e}' for r in pair]} (held to "
          f"{SPREAD_BF16_RTOL}); bf16 source, both on the plain warp "
          f"{[f'{r:.2e}' for r in pair_xla]} (held to {SPREAD_F32_RTOL}); "
          f"control, plain bf16 / f32 source "
          f"{[f'{r:.2e}' for r in control]} (must exceed "
          f"{SPREAD_F32_RTOL})", flush=True)
    if max(pair32) > SPREAD_F32_RTOL or max(pair) > SPREAD_BF16_RTOL \
            or max(pair_xla) > SPREAD_F32_RTOL:
        fail(f"adapt step-1 kernel/plain over seeds: f32 {pair32}, bf16 "
             f"{pair}, bf16 on the plain warp {pair_xla}")
    if min(control) <= SPREAD_F32_RTOL:
        fail(f"adapt step-1 control {control} within {SPREAD_F32_RTOL}: "
             "the f32 limit cannot tell a precision change from the "
             "summation order")


ADAPT_PATHS = (("kernel", ["segmenter.train_fused=pallas"]),
               ("plain", ["data.warp=xla", "segmenter.train_fused=none"]))


def adapt_setup(source_dir, config=CONFIG, domains=("mri", "ct")):
    """(device-resident source and target slices of the synthetic
    phantoms of ``domains``, source params, source BN) for an adapt step
    from the source run ``source_dir``."""
    from mcmda_tpu_torch import cli, weights
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.data import pipeline, synthetic, volumes

    data = {}
    for name, dom in zip(("src", "tgt"), domains):
        vols, _ = synthetic.make_dataset(0, dom, 4, max(16, SIZE // 4), SIZE)
        data[name] = pipeline.to_device_arrays(
            volumes.volumes_to_slices(vols, context=3), device=DEVICE)
    params, bn = weights.restore_source(cli._resolve_ckpt(source_dir),
                                        config_mod.load_config(config),
                                        DEVICE)
    return data, params, bn


def time_adapt_step(torch, source_dir, config=CONFIG, paths=ADAPT_PATHS,
                    label="adapt step", setup=None):
    """Median ms/step of make_adapt_step over TIMED_RUNS steps after 5
    warm-up steps, on each of ``paths`` (the kernel path and the plain
    path by default; same data and source checkpoint: ``setup``, else
    ``adapt_setup``'s mri2ct one), and ``profiling.measure_step`` of each;
    returns {path: ms/step} and {path + " profile": the measure_step
    dict}."""
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.train import adapt
    from mcmda_tpu_torch.utils import profiling

    data, params, bn = setup or adapt_setup(source_dir, config)
    out = {}
    for name, sets in paths:
        cfg = config_mod.load_config(config, sets)
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
        print(f"{label} {name}: {out[name]:.2f} ms/step (median of "
              f"{TIMED_RUNS} after 5 warm-up; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)",
              flush=True)
        out[name + " profile"] = profiling.measure_step(step, state, data)
        print_profile(f"{label} {name}", out[name + " profile"])
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
    # --synthetic-volumes 4 holds out one 64-slice target volume
    batches = -(-max(16, SIZE // 4) // BATCH)
    total = [0]
    agg = traced_run(torch, (fk,), total, "evaluate",
                     lambda: cli.cmd_evaluate(args),
                     *((n,) for n in served(n_sites, batches)))
    mean = agg["mean"]
    print(f"evaluate {os.path.basename(args.ckpt)}: "
          f"mean Dice {mean['dice']:.4f} ASSD {mean['assd']:.3f} HD95 "
          f"{mean['hd95']:.3f} misses {mean['assd_misses']}", flush=True)
    if args.ckpt != selected:
        fail(f"evaluate resolved {args.ckpt}, not the selected {selected}")
    if not all(math.isfinite(mean[k]) for k in ("dice", "assd", "hd95")):
        fail(f"evaluate: table not finite {mean}")
    vol, _ = synthetic.make_volume(np.random.default_rng(SEED + 1), "ct",
                                   depth=16, size=SIZE)
    vol_path = os.path.join(tmp, "in-adapt", "case2.npz")
    os.makedirs(os.path.dirname(vol_path))
    volumes.save_volume(vol_path, vol)
    pred_dir = os.path.join(tmp, "pred-adapt")
    if cli._resolve_ckpt(run_dir) != selected:
        fail("predict would not serve the selected checkpoint")
    rc = traced_run(torch, (fk,), total,
                    f"predict {os.path.basename(selected)}",
                    lambda: cli.main(["predict", "--config", CONFIG, "--ckpt",
                                      run_dir, "--input", vol_path, "--out",
                                      pred_dir, "--device", DEVICE, *sets]),
                    *((n,) for n in served(n_sites, -(-16 // BATCH))))
    mask = volumes.load_volume_with_spacing(
        os.path.join(pred_dir, "case2_pred.npz"))[0]
    counts = np.bincount(mask.astype(np.int64).ravel(), minlength=5)
    print(f"predict {os.path.basename(selected)}: mask {list(mask.shape)} "
          f"classes {counts.tolist()}", flush=True)
    if rc != 0 or mask.shape != (16, SIZE, SIZE):
        fail(f"predict of the adapted run: rc {rc}, mask {mask.shape}")
    return total[0]


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


# the device kernel that each counted wrapper launches once per count (a
# conv + moments launch also runs its reduce_partials_kernel), by module
DEVICE_KERNELS = {
    "warp": re.compile(r"\bwarp_(?:vec|staged|generic)_kernel\b"),
    "train_conv": re.compile(r"\bconv_stats_kernel\b"),
    "fused_conv": re.compile(r"\bconv_bn_act_kernel\b"),
}


def traced_launches(torch, kernels, fn):
    """Run ``fn()`` with the launch counts of ``kernels`` (kernel modules)
    at 0, under a torch.profiler trace of the device.  Returns (what ``fn``
    returns, wall s, the wrappers' counts, each kernel's executions on the
    device, and those of them that a CUDA graph replay ran: the ones whose
    launch call, by CUPTI's correlation id, is a graph launch).  A wrapper
    counts a launch that runs at once and one that a capture records; a
    replay runs the recorded ones with no wrapper call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pats = [DEVICE_KERNELS[k.__name__.rsplit(".", 1)[-1]] for k in kernels]
    torch.cuda.synchronize()
    for k in kernels:
        k.LAUNCHES = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host = tuple(k.LAUNCHES for k in kernels)
    events = prof.profiler.kineto_results.events()
    graph_calls = {e.correlation_id() for e in events
                   if e.device_type() == DeviceType.CPU
                   and "GraphLaunch" in e.name()}
    ran, replayed = [0] * len(kernels), [0] * len(kernels)
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        for i, pat in enumerate(pats):
            if pat.search(name):
                ran[i] += 1
                replayed[i] += e.correlation_id() in graph_calls
                break
    return out, wall, host, tuple(ran), tuple(replayed)


def on_graph(per_step, graphs=1):
    """What the wrappers of a device-resident training run on the CUDA
    graph launch: each graph's first call runs one step eagerly and
    captures one, 2 steps' launches (``per_step`` per kernel) a graph; its
    replays run the other steps with no wrapper call."""
    return tuple(2 * graphs * p for p in per_step)


def check_replays(label, host, replayed, per_step, steps, graphs=1):
    """Hold a traced run (``traced_launches``) of ``steps`` steps on
    ``graphs`` CUDA graphs: its wrappers launched ``on_graph``'s counts,
    and its replays ran each kernel the steps need, at most the other
    steps' launches (``per_step`` each).  The trace may lack records: on
    an H100 (torch 2.11) one 50-step call's trace lacked 2 whole replays,
    another an eager launch, so the replays it shows are a lower bound and
    are not held to the full count.  Returns what the run adds to the
    kernels line: the launches and the replays the trace shows."""
    most = [(steps - graphs) * p for p in per_step]
    _hold(label, host, replayed, on_graph(per_step, graphs), most)
    return [h + r for h, r in zip(host, replayed)]


def _hold(label, host, replayed, want, most):
    """Fail unless a traced run's wrappers launched ``want`` and its
    replays ran each kernel at most ``most`` times, and at least once
    where ``most`` is above 0."""
    if tuple(host) != tuple(want) or any(
            r > m or (m > 0) != (r > 0) for r, m in zip(replayed, most)):
        fail(f"{label}: wrapper launches {tuple(host)}, replayed "
             f"{tuple(replayed)}; expected {tuple(want)} and up to "
             f"{tuple(most)}, each kernel that replays at least once")


def served(n_sites, *batches):
    """(wrapper launches, most replayed) of the fused conv in a serving run
    (evaluate / predict) that captures one CUDA graph per volume of
    ``batches`` forward batches each (every command builds its own
    forward, so each of its volumes is a new graph here): the warm-up
    batch and the capture launch ``n_sites`` per batch through the
    wrapper, and the graph's replay runs ``n_sites`` per batch with no
    wrapper call."""
    return (n_sites * sum(b + 1 for b in batches),
            n_sites * sum(batches))


def traced_run(torch, kernels, total, label, fn, want, most):
    """Run ``fn`` under ``traced_launches`` with the counts of ``kernels``
    at 0; print them, hold the wrappers' launches to ``want`` and the
    replays to ``most`` (``_hold``: a trace may lack records, see
    ``check_replays``) and add launches and replays to ``total``.  Returns
    what ``fn`` returns."""
    out, wall, host, ran, replayed = traced_launches(torch, kernels, fn)
    print(f"{label}: wall {wall:.1f} s (traced); "
          + _launch_text(kernels, host, ran, replayed)
          + f"; expected {tuple(want)} launched, up to {tuple(most)} "
          "replayed", flush=True)
    _hold(label, host, replayed, want, most)
    for i, (h, r) in enumerate(zip(host, replayed)):
        total[i] += h + r
    return out


# the kernels line's names of the counted modules
LAUNCH_NAMES = {"warp": "warp", "train_conv": "conv_stats",
                "fused_conv": "fused conv"}


def _name(kernel):
    return LAUNCH_NAMES[kernel.__name__.rsplit(".", 1)[-1]]


def _launch_text(kernels, host, ran, replayed):
    """A traced run's counts; ``ran`` is every execution of the kernel
    that the trace holds (see ``check_replays``)."""
    return ", ".join(f"{_name(k)} {h} launched + {p} replayed (the trace "
                     f"holds {r})"
                     for k, h, r, p in zip(kernels, host, ran, replayed))


def counted_run(torch, kernels, total, label, fn, want):
    """Run ``fn`` with the launch counts of ``kernels`` (the warp, conv +
    moments and fused conv modules) at 0; print them, add them to
    ``total`` and hold them to ``want`` (``on_graph``'s for a
    device-resident training run).  Returns what ``fn`` returns."""
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
    print(f"{label}: wall {wall:.1f} s; launches "
          + ", ".join(f"{_name(k)} {n}" for k, n in zip(kernels, got)),
          flush=True)
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

    # 1. device-resident, through the API: one CUDA graph for T1, one each
    # for the critic pretrain and the adaptation
    t1_graph, ad_graph = on_graph((1, 15, 0)), on_graph((1, 15, 0), 2)
    src = counted("train_source", lambda: api.train_source(
        cfg, sv, sl, out_dir=d("src")), t1_graph)
    ad = counted("adapt", lambda: api.adapt(
        cfg, src, sv, sl, tgt_train, out_dir=d("ad")), ad_graph)
    api_run = check_runs("device-resident", d("src"), d("ad"), src, ad)
    fused, replays = served(n_sites, -(-depth // BATCH))
    table = traced_run(torch, (wk, tk, fk), total, "api evaluate",
                       lambda: api.evaluate(cfg, ad, test_v, test_l),
                       (0, 0, fused), (0, 0, replays))
    masks = traced_run(torch, (wk, tk, fk), total, "api predict",
                       lambda: api.predict(cfg, ad, test_v),
                       (0, 0, fused), (0, 0, replays))
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
               ["train-source", *common, "--out", d("cli-src")]), t1_graph),
           counted("cli adapt", lambda: cli.main(
               ["adapt", *common, "--source-ckpt", d("cli-src"), "--out",
                d("cli-ad")]), ad_graph)]
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

    # 3. host-sampler: the prefetching feed against a synchronous one, one
    # step per batch on a CUDA graph (T1; the critic pretrain and the
    # adaptation)
    t1_want, ad_want = t1_graph, ad_graph
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
                             t1_graph)
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

    # seed sweep: 1 warp + 15 conv + moments per T1 and adapt step, on a
    # CUDA graph for the source run and one for the seeds' adaptations;
    # the probes run the plain eval forward
    path = os.path.join(tmp, "sweep.json")
    art = counted_run(torch, kernels, total, "quality seed sweep",
                      lambda: seed_sweep.main([*SWEEP_ARGS, "--seeds",
                                               str(QUALITY_SEEDS), "--out",
                                               path]),
                      on_graph((1, 15, 0), 2))
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
                        on_graph((1, 15, 0), 2))
    a, b = json.loads(json.dumps(art)), json.loads(json.dumps(again))
    same = (a["per_seed"] == b["per_seed"], a["curves"] == b["curves"])
    print(f"quality seed sweep --merge: seed 0 kept, seed 1 rerun; rows "
          f"equal {same[0]}, curves equal {same[1]}", flush=True)
    if not all(same):
        fail("the --merge rerun did not reproduce the sweep bitwise")

    # synthetic benchmark, one direction: train-source, evaluate
    # --source-only, adapt, evaluate (traced); each evaluate captures the
    # held-out 64-slice volume's 8 forward batches as a CUDA graph, and
    # the two training runs take a graph each (BENCH_STEPS steps, no
    # critic pretrain in configs/mri2ct.json)
    res = os.path.join(tmp, "bench-results")
    batches = -(-max(16, SIZE // 4) // BATCH)
    fused, replays = served(n_sites, batches, batches)
    traced_run(torch, kernels, total, "quality synthetic benchmark mri2ct",
               lambda: synthetic_benchmark.main(
                   ["--direction", "mri2ct", "--runs",
                    os.path.join(tmp, "bench-runs"), "--results-dir", res,
                    *(a for kv in BENCH_SETS for a in ("--set", kv))]),
               (*on_graph((1, 15), 2), fused),
               ((2 * BENCH_STEPS - 2), 15 * (2 * BENCH_STEPS - 2), replays))
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


class _Draws:
    """``pipeline.draw_params`` replaced by a queue of injected draws while
    the block runs."""

    def __init__(self, pipeline):
        self.pipeline, self.queue = pipeline, []

    def __enter__(self):
        self.orig = self.pipeline.draw_params
        self.pipeline.draw_params = lambda *_a, **_k: self.queue.pop(0)
        return self

    def __exit__(self, *exc):
        self.pipeline.draw_params = self.orig
        return False


def _dp_case(torch):
    """Phase 12's configs, states, batch and draws, made from SEED on the
    card, identical in every process: {"t1": cfg, cap: adapt cfg}, the T1
    state, {cap: adapt state}, the T1 batch, the adapt batch (source and
    target images) and the draws of each (T1; adapt source, target)."""
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.data import pipeline, synthetic, volumes
    from mcmda_tpu_torch.train import adapt, source

    n = DP_RANKS * BATCH
    cfgs = {"t1": config_mod.load_config(CONFIG, DP_SETS)}
    for cap in DP_CAPS:
        cfgs[cap] = config_mod.load_config(
            CONFIG, DP_SETS + [f"adapt.d_acc_cap={cap}"])
    s0 = source.init_state(cfgs["t1"].run.seed, cfgs["t1"], DEVICE)
    a0 = {cap: adapt.init_state(cfgs[cap].run.seed + 2, cfgs[cap],
                                s0.params, s0.bn_state) for cap in DP_CAPS}
    sv, sl = synthetic.make_dataset(SEED, "mri", 1, n, SIZE)
    tv, _ = synthetic.make_dataset(SEED, "ct", 1, n, SIZE)
    src = volumes.volumes_to_slices(sv, sl, context=3)
    tgt = volumes.volumes_to_slices(tv, context=3)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            DEVICE)

    t1_batch = {"image": dev(src.images[:n]),
                "label": dev(np.eye(5, dtype=np.float32)[src.labels[:n]])}
    ad_batch = {"src_image": dev(src.images[:n]),
                "tgt_image": dev(tgt.images[:n])}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    draws = [pipeline.draw_params(gen, cfgs["t1"].data, n, DEVICE)
             for _ in range(3)]
    return cfgs, s0, a0, t1_batch, ad_batch, draws


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _dp_rank(rank, out_dir, port):
    """Phase 12 (a), one of DP_RANKS ranks on cuda:0 over gloo (a spawned
    process): one T1 step and one adapt step per cap on its shard, then
    DP_TIMED more of the T1 and the first adapt step timed; writes the
    states, metrics, times and launches."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from mcmda_tpu_torch import weights
    from mcmda_tpu_torch.data import pipeline
    from mcmda_tpu_torch.kernels import train_conv as tk, warp as wk
    from mcmda_tpu_torch.parallel import dp
    from mcmda_tpu_torch.train import adapt, source
    from mcmda_tpu_torch.utils import device as device_mod

    device_mod.resolve(DEVICE, deterministic=True)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=DP_RANKS, rank=rank)
    group = dist.group.WORLD
    cfgs, s0, a0, t1_b, ad_b, (d_t1, d_src, d_tgt) = _dp_case(torch)
    sl = slice(rank * BATCH, (rank + 1) * BATCH)
    res, meta = {}, {"ms": {}, "metrics": {}}
    wk.LAUNCHES = tk.LAUNCHES = 0
    with _Draws(pipeline) as draws:
        step = dp.data_parallel_step(
            source.make_train_step(cfgs["t1"], group=group), group)
        batch = {k: v[sl] for k, v in t1_b.items()}
        times = []
        for i in range(1 + DP_TIMED):
            draws.queue.append(d_t1[sl])
            (s1, m), ms = _timed(torch, lambda: step(s0, batch, 0))
            times.append(ms)
            if i == 0:
                res.update({f"t1/{k}": v for k, v in
                            weights.flatten_state(s1).items()})
                meta["metrics"]["t1"] = {k: float(v) for k, v in m.items()}
        meta["ms"]["t1"] = times
        batch = {k: v[sl] for k, v in ad_b.items()}
        for cap in DP_CAPS:
            step = dp.data_parallel_step(
                adapt.make_adapt_step(cfgs[cap], group=group), group)
            times = []
            for i in range(1 + (DP_TIMED if cap == DP_CAPS[0] else 0)):
                draws.queue.append(torch.cat([d_src[sl], d_tgt[sl]]))
                (a1, m), ms = _timed(torch, lambda: step(a0[cap], batch, 0))
                times.append(ms)
                if i == 0:
                    res.update({f"{cap}/{k}": v for k, v in
                                weights.flatten_state(a1).items()})
                    meta["metrics"][str(cap)] = {k: float(v)
                                                 for k, v in m.items()}
            meta["ms"][str(cap)] = times
    meta["launches"] = [wk.LAUNCHES, tk.LAUNCHES]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def _cli_rank(rank, argvs, port, out_dir):
    """Phase 12 (b), one rank of the CLI with --multihost over gloo (a
    spawned process): writes its exit code, standard output and kernel
    launches."""
    sys.path.insert(0, ROOT)
    import contextlib
    import io
    from mcmda_tpu_torch import cli
    from mcmda_tpu_torch.kernels import train_conv as tk, warp as wk

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = cli.main([*argvs[rank], "--multihost", "--coordinator",
                       f"127.0.0.1:{port}", "--num-processes",
                       str(DP_RANKS), "--process-id", str(rank), "--gloo"])
    with open(os.path.join(out_dir, f"cli{rank}.json"), "w") as f:
        json.dump({"rc": rc, "log": log.getvalue(),
                   "launches": [wk.LAUNCHES, tk.LAUNCHES]}, f)


def _nccl_pair_rank(rank, out_dir, port):
    """Phase 12 (c): one of two NCCL ranks on cuda:0, which NCCL is
    expected to refuse; writes what the first all-reduce did."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                f"{port}", world_size=2, rank=rank)
        v = torch.ones(1, device=DEVICE)
        dist.all_reduce(v)
        torch.cuda.synchronize()
        out = f"ran: all-reduce gave {v.item()}"
    except Exception as e:  # the error is the observation
        out = f"{type(e).__name__}: {e}"
    with open(os.path.join(out_dir, f"nccl{rank}.txt"), "w") as f:
        f.write(out)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(fn, args, label, timeout=DP_TIMEOUT):
    """Run ``fn(rank, *args)`` in DP_RANKS spawned processes; fails the
    smoke if one fails or they outlast ``timeout`` seconds."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=DP_RANKS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                fail(f"{label}: ranks still running after {timeout} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        fail(f"{label}: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _max_diff(got, want, prefixes):
    keys = [k for k in want if k.startswith(prefixes)]
    if not keys:
        fail(f"no state under {prefixes}")
    return max(float(np.abs(got[k] - want[k]).max()) for k in keys)


def _mu_rel(got, want, prefix):
    """Largest |mu difference| over the largest |mu| (Adam's first moment
    after one step is (1 - beta1) times the gradient); 0 where both are 0
    (a throttled critic)."""
    keys = [k for k in want if k.startswith(prefix)]
    top = max(float(np.abs(want[k]).max()) for k in keys)
    diff = _max_diff(got, want, (prefix,))
    return diff / top if top else diff


def _sure_diff(got, want, params, mu):
    """(largest |parameter difference| where the gradient's sign is
    determined, the share of parameters where it is not): determined where
    the one-process |mu| exceeds twice the largest |mu| difference of its
    tensor (``mu`` names Adam's first moment of the ``params`` tree)."""
    worst, undetermined, total = 0.0, 0, 0
    for k in [k for k in want if k.startswith(params)]:
        m = k.replace(params, mu, 1)
        sure = np.abs(want[m]) > 2 * np.abs(got[m] - want[m]).max()
        if sure.any():
            worst = max(worst, float(np.abs(got[k] - want[k])[sure].max()))
        undetermined += int((~sure).sum())
        total += sure.size
    return worst, undetermined / total


def _dp_check(label, got, want, rel_keys, limits, grads=(), sure=()):
    """Hold a DP rank's results to the one-process results: each metric in
    ``rel_keys`` within its relative limit, each state prefix group within
    its absolute limit, each Adam first moment in ``grads`` within
    DP_GRAD_RTOL of its largest value, each (parameters, first moment) pair
    in ``sure`` within DP_PARAM_ATOL where the gradient's sign is
    determined; prints the readings."""
    out = []
    for mu in grads:
        rel = _mu_rel(got["state"], want["state"], mu)
        out.append(f"grads {mu.split('/')[1]} max |diff| / max |g| "
                   f"{rel:.2e} (limit {DP_GRAD_RTOL})")
        if rel > DP_GRAD_RTOL:
            fail(f"{label}: gradient {mu} rel {rel} > {DP_GRAD_RTOL}")
    for params, mu in sure:
        d, share = _sure_diff(got["state"], want["state"], params, mu)
        out.append(f"{params} max |diff| where the gradient's sign is "
                   f"determined {d:.2e} (limit {DP_PARAM_ATOL}; "
                   f"undetermined share {share:.2e})")
        if d > DP_PARAM_ATOL:
            fail(f"{label}: {params} max |diff| {d} > {DP_PARAM_ATOL}")
    for key, lim in rel_keys:
        a, b = got["metrics"][key[0]][key[1]], want["metrics"][key[0]][
            key[1]]
        rel = abs(a - b) / max(abs(b), 1e-30)
        out.append(f"{key[1]} {a!r} vs {b!r} (rel {rel:.2e}, limit {lim})")
        if rel > lim:
            fail(f"{label}: {key[1]} rel {rel} > {lim}")
    for prefixes, lim in limits:
        d = _max_diff(got["state"], want["state"], prefixes)
        out.append(f"{'/'.join(prefixes)} max |diff| {d:.2e} (limit {lim})")
        if d > lim:
            fail(f"{label}: {prefixes} max |diff| {d} > {lim}")
    return "; ".join(out)


def phase_dp(torch, wk, tk, tmp):
    """Phase 12: data parallelism on the card.  (a) 2 ranks on cuda:0 over
    gloo, one T1 step and one adapt step per cap, against one process on
    the batch of 16; (b) train-source and adapt --multihost through the
    CLI on 2 ranks over gloo; (c) a one-rank NCCL world's T1 step against
    the step without a group, two NCCL ranks on one GPU, and --dp beyond
    the devices.  Returns [warp, conv + moments] launches of the phase."""
    import torch.distributed as dist
    from mcmda_tpu_torch import cli, weights
    from mcmda_tpu_torch.data import pipeline
    from mcmda_tpu_torch.parallel import dp
    from mcmda_tpu_torch.train import adapt, source
    from mcmda_tpu_torch.utils import device as device_mod

    launches = [0, 0]
    # deterministic cuDNN, as in the ranks: (c) compares two steps bitwise
    device_mod.resolve(DEVICE, deterministic=True)
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "dp")
    os.makedirs(out)

    # (a) two ranks over gloo against one process
    t0 = time.perf_counter()
    _spawn(_dp_rank, (out, _free_port()), "dp 2-rank steps")
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            meta = json.load(f)
        meta["state"] = dict(np.load(os.path.join(out, f"rank{r}.npz")))
        ranks.append(meta)
        launches[0] += meta["launches"][0]
        launches[1] += meta["launches"][1]
        want = [(1 + DP_TIMED) * 1 + (1 + DP_TIMED + 1) * 1,
                (1 + DP_TIMED) * 15 + (1 + DP_TIMED + 1) * 30]
        if meta["launches"] != want:
            fail(f"dp rank {r}: launches {meta['launches']}, expected {want}")
    for k in ranks[0]["state"]:
        if not np.array_equal(ranks[0]["state"][k], ranks[1]["state"][k]):
            fail(f"dp ranks differ after the step: {k}")
    cfgs, s0, a0, t1_b, ad_b, (d_t1, d_src, d_tgt) = _dp_case(torch)
    one = {"state": {}, "metrics": {}, "ms": {}}
    wk.LAUNCHES = tk.LAUNCHES = 0
    with _Draws(pipeline) as draws:
        step = source.make_train_step(cfgs["t1"])
        times = []
        for i in range(1 + DP_TIMED):
            draws.queue.append(d_t1)
            (s1, m), ms = _timed(torch, lambda: step(s0, t1_b, 0))
            times.append(ms)
        one["ms"]["t1"] = times
        one["state"].update({f"t1/{k}": v for k, v in
                             weights.flatten_state(s1).items()})
        one["metrics"]["t1"] = {k: float(v) for k, v in m.items()}
        for cap in DP_CAPS:
            draws.queue.append(torch.cat([d_src, d_tgt]))
            a1, m = adapt.make_adapt_step(cfgs[cap])(a0[cap], ad_b, 0)
            one["state"].update({f"{cap}/{k}": v for k, v in
                                 weights.flatten_state(a1).items()})
            one["metrics"][str(cap)] = {k: float(v) for k, v in m.items()}
        # the same step with the shards in the other order: how far one
        # process moves from itself when only the summation order changes
        rot = torch.cat([torch.arange(BATCH, 2 * BATCH),
                         torch.arange(BATCH)]).to(DEVICE)
        draws.queue.append(d_t1[rot])
        s1r, m = source.make_train_step(cfgs["t1"])(
            s0, {k: v[rot] for k, v in t1_b.items()}, 0)
        cap = DP_CAPS[0]
        draws.queue.append(torch.cat([d_src[rot], d_tgt[rot]]))
        a1r, am = adapt.make_adapt_step(cfgs[cap])(
            a0[cap], {k: v[rot] for k, v in ad_b.items()}, 0)
        reord = {"state": {
            **{f"t1/{k}": v for k, v in weights.flatten_state(s1r).items()},
            **{f"{cap}/{k}": v for k, v in
               weights.flatten_state(a1r).items()}},
            "metrics": {"t1": {k: float(v) for k, v in m.items()},
                        str(cap): {k: float(v) for k, v in am.items()}}}
    launches[0] += wk.LAUNCHES
    launches[1] += tk.LAUNCHES
    got = ranks[0]
    c0 = str(cap)
    print("dp (a) the one process against itself with the batch "
          "reordered (summation order alone): T1 loss "
          f"{reord['metrics']['t1']['loss']!r}; params max |diff| "
          f"{_max_diff(reord['state'], one['state'], ('t1/.params',)):.2e}"
          "; BN "
          f"{_max_diff(reord['state'], one['state'], ('t1/.bn_state',)):.2e}"
          "; grads max |diff| / max |g| "
          f"{_mu_rel(reord['state'], one['state'], 't1/.opt_state[0].mu'):.2e}"
          f"; adapt d_acc {reord['metrics'][c0]['d_acc']!r}, DAM "
          f"{_max_diff(reord['state'], one['state'], (f'{c0}/.dam_params',)):.2e}"
          ", grads DAM "
          f"{_mu_rel(reord['state'], one['state'], f'{c0}/.opt_g_state[0].mu'):.2e}"
          ", critic "
          f"{_mu_rel(reord['state'], one['state'], f'{c0}/.opt_d_state[0].mu'):.2e}",
          flush=True)
    print("dp (a) T1, 2 ranks x 8 on cuda:0 over gloo vs one process x "
          "16: " + _dp_check(
              "dp T1", got, one, [(("t1", "loss"), STEP1_RTOL)],
              [(("t1/.bn_state",), DP_BN_ATOL)],
              grads=("t1/.opt_state[0].mu",),
              sure=(("t1/.params", "t1/.opt_state[0].mu"),))
          + "; ranks bitwise equal", flush=True)
    for cap in DP_CAPS:
        c = str(cap)
        rel = [((c, "d_acc"), DP_DACC_RTOL), ((c, "d_loss"), STEP1_RTOL),
               ((c, "g_loss"), STEP1_RTOL)]
        print(f"dp (a) adapt, d_acc_cap {cap} (critic step "
              f"{'taken' if one['metrics'][c]['d_acc'] <= cap else 'held'}"
              "): " + _dp_check(
                  f"dp adapt cap {cap}", got, one, rel,
                  [((f"{c}/.dam_params",), DP_PARAM_ATOL),
                   ((f"{c}/.critic_params", f"{c}/.opt_d_state"),
                    DP_CRITIC_ATOL),
                   ((f"{c}/.tgt_bn",), DP_BN_ATOL)],
                  grads=(f"{c}/.opt_g_state[0].mu",
                         f"{c}/.opt_d_state[0].mu"))
              + "; ranks bitwise equal", flush=True)
    card = device_mod.card()
    med = {k: [statistics.median(r["ms"][k][1:]) for r in ranks]
           for k in ("t1", str(DP_CAPS[0]))}
    print(f"dp (a) step ms on {card}, gloo through the host on one card "
          f"(not multi-GPU scaling), median of {DP_TIMED} after the first: "
          f"T1 ranks {med['t1']}, adapt ranks {med[str(DP_CAPS[0])]}; one "
          f"process at batch 16: T1 "
          f"{statistics.median(one['ms']['t1'][1:]):.2f}; spawn to exit "
          f"{wall:.1f} s", flush=True)

    # (b) the CLI across two processes
    runs = {}
    for cmd in ("train-source", "adapt"):
        outs = [os.path.join(out, f"{cmd}{r}") for r in range(DP_RANKS)]
        argvs = []
        for r in range(DP_RANKS):
            argv = [cmd, "--config", CONFIG, "--synthetic",
                    "--synthetic-volumes", "2", "--device", DEVICE,
                    "--out", outs[r]]
            if cmd == "adapt":
                argv += ["--source-ckpt", runs["train-source"][0]]
            for kv in (f"source.steps={DP_CLI_STEPS}",
                       f"adapt.steps={DP_CLI_STEPS}",
                       "adapt.pretrain_steps=0", "run.ckpt_every=2",
                       "run.log_every=1", "segmenter.train_fused=pallas"):
                argv += ["--set", kv]
            argvs.append(argv)
        t0 = time.perf_counter()
        _spawn(_cli_rank, (argvs, _free_port(), out), f"dp cli {cmd}")
        wall = time.perf_counter() - t0
        logs = []
        for r in range(DP_RANKS):
            with open(os.path.join(out, f"cli{r}.json")) as f:
                rec = json.load(f)
            if rec["rc"] != 0:
                fail(f"dp cli {cmd} rank {r}: exit {rec['rc']}")
            if rec["launches"] != [DP_CLI_STEPS, 15 * DP_CLI_STEPS]:
                fail(f"dp cli {cmd} rank {r}: launches {rec['launches']}")
            launches[0] += rec["launches"][0]
            launches[1] += rec["launches"][1]
            done = [ln for ln in rec["log"].splitlines()
                    if ln.startswith(f"done (rank {r} of {DP_RANKS})")]
            if len(done) != 1 or "(per-rank sharded)" not in rec["log"]:
                fail(f"dp cli {cmd} rank {r}: {rec['log'][-1500:]}")
            logs.append(done[0].split("last logged ", 1)[1])
        if logs[0] != logs[1]:
            fail(f"dp cli {cmd}: ranks printed {logs}")
        if os.path.exists(outs[1]):
            fail(f"dp cli {cmd}: rank 1 wrote {os.listdir(outs[1])}")
        names = sorted(os.listdir(outs[0]))
        with open(os.path.join(outs[0], "metrics.jsonl")) as f:
            sigs = [(r["step"], frozenset(r)) for r in map(json.loads, f)]
        want = {"step_00000002.npz", f"step_{DP_CLI_STEPS:08d}.npz",
                "metrics.jsonl"}
        if cmd == "adapt":
            with open(os.path.join(outs[0], "selection.json")) as f:
                best = json.load(f)["best_step"]
            want |= {"selection.json", "snapshots", f"step_{best:08d}.npz"}
        if not want <= set(names) or len(sigs) != len(set(sigs)):
            fail(f"dp cli {cmd}: rank 0 wrote {names}, {len(sigs)} metric "
                 f"lines, {len(set(sigs))} distinct")
        runs[cmd] = outs
        print(f"dp (b) {cmd} --multihost, 2 ranks on cuda:0 over gloo, "
              f"{DP_CLI_STEPS} steps: wall {wall:.1f} s; launches per rank "
              f"warp {DP_CLI_STEPS}, conv_stats {15 * DP_CLI_STEPS}; rank 0 "
              f"wrote {names}; rank 1 wrote nothing; both ranks: last "
              f"logged {logs[0]}", flush=True)

    # (c) NCCL: one rank, two ranks on one GPU, --dp beyond the devices
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        v = torch.arange(4.0, device=DEVICE)
        dist.all_reduce(v)
        torch.cuda.synchronize()
        if dist.get_backend() != "nccl" or \
                not torch.equal(v, torch.arange(4.0, device=DEVICE)):
            fail(f"nccl one-rank all-reduce: {dist.get_backend()} {v}")
        batch = {k: t[:BATCH] for k, t in t1_b.items()}
        wk.LAUNCHES = tk.LAUNCHES = 0
        with _Draws(pipeline) as draws:
            draws.queue += [d_t1[:BATCH], d_t1[:BATCH]]
            ref, rm = source.make_train_step(cfgs["t1"])(s0, batch, 0)
            step = dp.data_parallel_step(
                source.make_train_step(cfgs["t1"], group=group), group)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                got, gm = step(s0, batch, 0)
                torch.cuda.synchronize()
        launches[0] += wk.LAUNCHES
        launches[1] += tk.LAUNCHES
        nccl = sorted({e.key for e in prof.key_averages()
                       if "nccl" in e.key.lower()})
        a, b = weights.flatten_state(got), weights.flatten_state(ref)
        same = [k for k in a if np.array_equal(a[k], b[k])]
        print(f"dp (c) one-rank NCCL world: backend {dist.get_backend()}; "
              f"T1 step loss {float(gm['loss'])!r} vs without a group "
              f"{float(rm['loss'])!r}; {len(same)} of {len(a)} state "
              f"tensors bitwise equal; NCCL events in the step's profile: "
              f"{nccl}", flush=True)
        if float(gm["loss"]) != float(rm["loss"]) or len(same) != len(a):
            fail("one-rank NCCL T1 step differs from the step without a "
                 "group")
    finally:
        dist.destroy_process_group()
    _spawn(_nccl_pair_rank, (out, _free_port()), "nccl pair", timeout=120)
    for r in range(DP_RANKS):
        with open(os.path.join(out, f"nccl{r}.txt")) as f:
            print(f"dp (c) two NCCL ranks on cuda:0, rank {r}: "
                  f"{f.read()[:400]}", flush=True)
    n = max(2, torch.cuda.device_count() + 1)
    try:
        cli.main(["train-source", "--config", CONFIG, "--synthetic",
                  "--out", os.path.join(out, "refused"), "--device",
                  DEVICE, "--dp", str(n)])
    except SystemExit as e:
        msg = str(e)
    else:
        fail(f"--dp {n} on {torch.cuda.device_count()} GPU(s) ran")
    print(f"dp (c) --dp {n}: {msg}", flush=True)
    if "more ranks than devices" not in msg:
        fail(f"--dp {n}: {msg}")
    return launches


# phase 13: the reverse direction, configs/ct2mri.json as shipped (plug
# depth rm2: the DAM is stem + rm1 + rm2, rm3 onwards frozen higher layers
# under batch-statistic BN; critic throttled at d_acc 0.9; a probe every
# 100 steps, capped to a quarter of a short run; flip TTA at evaluation)
# with the kernels asked for.  (name, extra adapt --set overrides, steps,
# warp launches per step, conv-moments launches per step), as ADAPT_RUNS.
CT2MRI = os.path.join(ROOT, "configs", "ct2mri.json")
CT_SOURCE_STEPS = 10
CT_ADAPT_RUNS = (
    ("kernel", ["segmenter.train_fused=pallas", "run.ckpt_every=10"],
     ADAPT_STEPS, 1, 15),
    ("kernel-5a", ["segmenter.train_fused=pallas"], 5, 1, 15),
    ("kernel-5b", ["segmenter.train_fused=pallas"], 5, 1, 15),
    ("plain", ["data.warp=xla", "segmenter.train_fused=none"], 1, 0, 0),
    ("kernel-f32", ["segmenter.train_fused=pallas", F32_SRC], 1, 1, 30),
    ("plain-f32", ["data.warp=xla", "segmenter.train_fused=none", F32_SRC],
     1, 0, 0),
    ("ema", ["segmenter.train_fused=pallas", "adapt.dam_ema=0.5"], 10, 1,
     15),
)
# rm2 against rm3 on the same source state and data: the weight gradients
# the conv + moments backward computes in one step (its 15 sites sit in
# rm3-rm6; at rm2 all are frozen, at rm3 rm3's 3 are the DAM's)
CT_WGRADS = {"rm2": 0, "rm3": 3}
ABLATE_ARGS = ["--device", DEVICE, "--source-steps", "20",
               "--pretrain-steps", "2", "--adapt-steps", "10"]


class _CountWgrad:
    """``torch.nn.grad`` in ``kernels/train_conv.py`` with its weight
    gradients counted."""

    def __init__(self, grad):
        self.grad, self.n = grad, 0

    def conv2d_input(self, *a, **k):
        return self.grad.conv2d_input(*a, **k)

    def conv2d_weight(self, *a, **k):
        self.n += 1
        return self.grad.conv2d_weight(*a, **k)


def audit_adapt_step(torch, tk, setup):
    """One make_adapt_step at each plug depth of CT_WGRADS (ct2mri, kernel
    path, the same ``adapt_setup``): the weight gradients of the conv +
    moments backward, and at rm2 the host synchronisations of the step
    (the throttle decides on the device: none may happen)."""
    import warnings
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.train import adapt

    data, params, bn = setup
    for depth, want in CT_WGRADS.items():
        cfg = config_mod.load_config(CT2MRI, [
            "segmenter.train_fused=pallas", f"adapt.plug_depth={depth}"])
        state = adapt.init_state(cfg.run.seed + 2, cfg, params, bn)
        step = adapt.make_adapt_step(cfg, sample_from_device=True)
        state, _ = step(state, data, 0)  # warm-up
        torch.cuda.synchronize()
        counter = _CountWgrad(tk.nn_grad)
        tk.nn_grad = counter
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    state, metrics = step(state, data, 1)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        finally:
            tk.nn_grad = counter.grad
        # "called a synchronizing CUDA operation" (the mode's notice that it
        # is a prototype is no synchronisation)
        syncs = [str(w.message)[:120] for w in caught
                 if "called a synchronizing" in str(w.message)]
        dam = sorted(state.dam_params)
        print(f"ct2mri adapt step at {depth}: DAM {dam}; conv + moments "
              f"weight gradients {counter.n} (expected {want}); host "
              f"synchronisations in the step {len(syncs)}"
              + (f" ({syncs[0]})" if syncs else "") + f"; d_acc "
              f"{float(metrics['d_acc']):.4f}", flush=True)
        if counter.n != want:
            fail(f"ct2mri {depth}: {counter.n} conv + moments weight "
                 f"gradients, expected {want}")
        if depth == "rm2" and syncs:
            fail(f"ct2mri rm2 step synchronises with the host: {syncs}")
        del state


def _probe_steps(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["step"] for line in f
                if "class_ratio_dist" in line]


def phase_ct2mri(torch, wk, tk, fk, tmp, n_sites, rm3_ms):
    """Phase 13: the ct2mri recipe through the CLI at full width.  (a)
    train-source on CT; (b) adapt from it (CT_ADAPT_RUNS: probe cadence,
    selection, the pick, snapshots, repeatable losses, step-1 kernel/plain
    pairs), make_adapt_step at rm2 timed on both paths and at rm3, the
    weight gradients and host synchronisations of a step; (c) the EMA
    variant's selection; (d) evaluate (flip TTA, bf16, fused) and predict of
    the pick against the plain path and an f64 fused conv; (e) the
    plug-depth ablation twin at toy lengths.  Returns [warp, conv +
    moments, fused conv] launches."""
    import contextlib
    import io
    from mcmda_tpu_torch import api, cli
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.data import synthetic, volumes
    from mcmda_tpu_torch.scripts import ablate_plug_depth

    t_phase = time.perf_counter()
    total = [0, 0, 0]
    kernels = (wk, tk, fk)
    common = ["--config", CT2MRI, "--direction", "ct2mri", "--synthetic",
              "--device", DEVICE]

    def sets(*kvs):
        return [a for kv in kvs for a in ("--set", kv)]

    # (a) T1 on the labelled CT phantoms
    src = os.path.join(tmp, "ct2mri-source")
    rc = counted_run(torch, kernels, total, "ct2mri train-source",
                     lambda: cli.main(["train-source", *common, "--out", src,
                                       *sets(f"source.steps="
                                             f"{CT_SOURCE_STEPS}",
                                             "run.log_every=1",
                                             "segmenter.train_fused=pallas")]),
                     on_graph((1, 15, 0)))
    losses, _ = _losses(src)
    print(f"ct2mri train-source: loss first {losses[0]:.6f} last "
          f"{losses[-1]:.6f}", flush=True)
    if rc != 0 or len(losses) != CT_SOURCE_STEPS or \
            not np.isfinite(losses).all():
        fail(f"ct2mri train-source: rc {rc}, losses {losses}")

    # (b), (c) adapt from it
    runs = {}
    for name, extra, steps, n_warp, n_conv in CT_ADAPT_RUNS:
        out = os.path.join(tmp, "ct2mri-adapt-" + name)
        rc = counted_run(
            torch, kernels, total, f"ct2mri adapt {name} ({steps} steps)",
            lambda: cli.main(["adapt", *common, "--source-ckpt", src,
                              "--out", out,
                              *sets(f"adapt.steps={steps}", "run.log_every=1",
                                    *extra)]),
            on_graph((n_warp, n_conv, 0)))
        m = _adapt_metrics(out)
        runs[name] = m
        with open(os.path.join(out, "selection.json")) as f:
            sel = json.load(f)
        probes = _probe_steps(out)
        every = api._select_every(config_mod.load_config(CT2MRI), steps)
        print(f"ct2mri adapt {name}: d_loss first {m['d_loss'][0]:.6f} last "
              f"{m['d_loss'][-1]:.6f}; g_loss first {m['g_loss'][0]:.6f} "
              f"last {m['g_loss'][-1]:.6f}; d_acc {min(m['d_acc']):.4f}-"
              f"{max(m['d_acc']):.4f}; probes at {probes}; selected step "
              f"{sel['best_step']} ({sel['weights']} weights)", flush=True)
        if rc != 0 or any(len(v) != steps or not np.isfinite(v).all()
                          for v in m.values()):
            fail(f"ct2mri adapt {name}: rc {rc}, metrics {m}")
        if probes != list(range(every, steps + 1, every)):
            fail(f"ct2mri adapt {name}: probes at {probes}, expected every "
                 f"{every}")
        if not os.path.exists(os.path.join(
                out, f"step_{sel['best_step']:08d}.npz")):
            fail(f"ct2mri adapt {name}: selected step {sel['best_step']} "
                 "not materialized")
        if name == "ema":
            with open(os.path.join(out, "metrics.jsonl")) as f:
                dual = "class_ratio_dist_avg" in f.read()
            if sel["weights"] not in ("live", "avg") or not dual:
                fail(f"ct2mri adapt ema: selection {sel}, both variants "
                     f"probed {dual}")
    kernel_dir = os.path.join(tmp, "ct2mri-adapt-kernel")
    snaps = sorted(os.listdir(os.path.join(kernel_dir, "snapshots")))
    if snaps != ["step_00000010.png", "step_00000020.png"]:
        fail(f"ct2mri adapt kernel: snapshots {snaps}")
    a, b = runs["kernel-5a"], runs["kernel-5b"]
    same = a["d_loss"] == b["d_loss"] and a["g_loss"] == b["g_loss"]
    print(f"ct2mri adapt: two 5-step kernel runs "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if not same:
        fail(f"seeded ct2mri adapt runs differ: {a} vs {b}")
    for kern, plain in (("kernel-f32", "plain-f32"), ("kernel-5a", "plain")):
        k_m, p_m = runs[kern], runs[plain]
        rel = {k: abs(p_m[k][0] - k_m[k][0]) / abs(k_m[k][0])
               for k in ("d_loss", "g_loss")}
        print(f"ct2mri adapt step-1 {kern} / {plain}: d_loss "
              f"{k_m['d_loss'][0]!r} / {p_m['d_loss'][0]!r} (rel "
              f"{rel['d_loss']:.2e}), g_loss {k_m['g_loss'][0]!r} / "
              f"{p_m['g_loss'][0]!r} (rel {rel['g_loss']:.2e}); held to "
              f"{STEP1_RTOL}", flush=True)
        if max(rel.values()) > STEP1_RTOL:
            fail(f"ct2mri adapt step-1 {kern}/{plain} rel diff {rel}")
    setup = adapt_setup(src, CT2MRI, ("ct", "mri"))
    ms = time_adapt_step(
        torch, src, CT2MRI,
        (*((f"rm2 {n}", sets) for n, sets in ADAPT_PATHS),
         ("rm3 kernel", ["segmenter.train_fused=pallas",
                         "adapt.plug_depth=rm3"])),
        label="ct2mri adapt step", setup=setup)
    busy, n_kernels = ({k: ms[f"{k} profile"][m] for k in
                        ("rm2 kernel", "rm3 kernel")}
                       for m in ("device_busy_ms_per_step",
                                 "kernels_per_step"))
    print(f"adapt step ms/step, kernel / plain path: ct2mri rm2 "
          f"{ms['rm2 kernel']:.2f} / {ms['rm2 plain']:.2f}; ct2mri rm3 "
          f"(kernel) {ms['rm3 kernel']:.2f}; phase 8's mri2ct rm3 "
          f"{rm3_ms['kernel']:.2f} / {rm3_ms['plain']:.2f}; kernel path "
          f"device busy per step rm2 {busy['rm2 kernel']:.2f} vs rm3 "
          f"{busy['rm3 kernel']:.2f} ms, kernels per step "
          f"{n_kernels['rm2 kernel']:.0f} vs {n_kernels['rm3 kernel']:.0f}",
          flush=True)
    audit_adapt_step(torch, tk, setup)
    del setup

    # (d) evaluate and serve the pick: flip TTA (one forward batch of 16
    # per 8 slices), bf16, fused path
    with open(os.path.join(kernel_dir, "selection.json")) as f:
        best = json.load(f)["best_step"]
    selected = os.path.join(kernel_dir, f"step_{best:08d}")
    use_pallas = sets(*SETS)
    args = cli.build_parser().parse_args(
        ["evaluate", *common, "--ckpt", kernel_dir, *use_pallas])
    fused, replays = served(n_sites, -(-max(16, SIZE // 4) // BATCH))
    agg = traced_run(torch, kernels, total, "ct2mri evaluate (flip TTA)",
                     lambda: cli.cmd_evaluate(args), (0, 0, fused),
                     (0, 0, replays))
    mean = agg["mean"]
    print(f"ct2mri evaluate {os.path.basename(args.ckpt)}: mean Dice "
          f"{mean['dice']:.4f} ASSD {mean['assd']:.3f} HD95 "
          f"{mean['hd95']:.3f} misses {mean['assd_misses']}", flush=True)
    if args.ckpt != selected:
        fail(f"ct2mri evaluate resolved {args.ckpt}, not {selected}")
    if not all(math.isfinite(mean[k]) for k in ("dice", "assd", "hd95")):
        fail(f"ct2mri evaluate: table not finite {mean}")
    vol, _ = synthetic.make_volume(np.random.default_rng(SEED + 2), "mri",
                                   depth=SLICES, size=SIZE)
    vol_path = os.path.join(tmp, "in-ct2mri", "case3.npz")
    os.makedirs(os.path.dirname(vol_path))
    volumes.save_volume(vol_path, vol)
    argv = ["predict", "--config", CT2MRI, "--ckpt", kernel_dir, "--input",
            vol_path, "--device", DEVICE, *use_pallas]
    outs = {v: os.path.join(tmp, f"pred-ct2mri-{v}")
            for v in ("kernel", "plain", "exact")}
    fused, replays = served(n_sites, SLICES // BATCH)
    rc = traced_run(torch, kernels, total, "ct2mri predict (flip TTA)",
                    lambda: cli.main(argv + ["--out", outs["kernel"]]),
                    (0, 0, fused), (0, 0, replays))
    cli.cmd_predict(cli.build_parser().parse_args(
        argv + ["--out", outs["plain"]]), use_kernel=False)
    predict_exact(cli, fk, argv + ["--out", outs["exact"]])
    masks = {v: volumes.load_volume_with_spacing(
        os.path.join(d, "case3_pred.npz"))[0] for v, d in outs.items()}

    def agree(x, y):
        return float((masks[x] == masks[y]).mean())

    kp, ke, pe = (agree("kernel", "plain"), agree("kernel", "exact"),
                  agree("plain", "exact"))
    counts = np.bincount(masks["kernel"].astype(np.int64).ravel(),
                         minlength=5)
    print(f"ct2mri predict {os.path.basename(selected)}: mask "
          f"{list(masks['kernel'].shape)} classes {counts.tolist()}; voxel "
          f"agreement kernel/plain {kp:.6f} "
          f"({int((masks['kernel'] != masks['plain']).sum())} differ), "
          f"kernel/exact {ke:.6f}, plain/exact {pe:.6f}", flush=True)
    if rc != 0 or masks["kernel"].shape != (SLICES, SIZE, SIZE):
        fail(f"ct2mri predict: rc {rc}, mask {masks['kernel'].shape}")
    if kp < 0.995:
        fail(f"ct2mri predict: kernel/plain agreement {kp} < 0.995")
    if ke < pe - EXACT_SLACK:
        fail(f"ct2mri predict: the kernel path is further from the f64 "
             f"answer than the plain path ({ke} < {pe})")

    # (e) the plug-depth ablation twin (configs/smoke.json: plain paths)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = counted_run(torch, kernels, total, "ct2mri ablation twin",
                         lambda: ablate_plug_depth.main(ABLATE_ARGS),
                         (0, 0, 0))
    lines = [ln for ln in log.getvalue().splitlines()
             if ln.startswith(("no-adapt", "plug_depth=", "best depth",
                               "ct2mri ablation"))]
    print("ct2mri ablation twin: " + " | ".join(lines), flush=True)
    depths = [ln.split(":")[0] for ln in lines
              if ln.startswith("plug_depth=")]
    if rc != 0 or depths != [f"plug_depth={d}" for d in
                             ("rm1", "rm2", "rm3")] or \
            not any(ln.startswith("best depth") for ln in lines):
        fail(f"ablation twin: exit {rc}, lines {lines}")
    print(f"ct2mri phase: {time.perf_counter() - t_phase:.1f} s; launches "
          f"warp {total[0]}, conv_stats {total[1]}, fused conv {total[2]}",
          flush=True)
    return total


# phase 14: the compiled multi-step dispatch.  SCAN_INNER train steps per
# call, what drivers.pick_inner gives for both shipped configs; a timed
# path is the median of SCAN_TIMED calls after a warm-up call (the call
# that held it against the other path), and
# measure_step reads calls of SCAN_PROFILE steps of each path (a 50-step
# eager call under the profiler would hold some 175,000 kernel events).
SCAN_INNER = 50
SCAN_TIMED = 3
SCAN_PROFILE = 5
SCAN_NCCL = 10
# (d) the CLI on the graph: 100 T1 steps, then 50 critic pretrain + 100
# adapt steps; log every 25, checkpoint every 50, probe every 25, so
# pick_inner gives 25 steps per call for both
SCAN_CLI_SETS = ["segmenter.train_fused=pallas", "source.steps=100",
                 "adapt.pretrain_steps=50", "adapt.steps=100",
                 "run.log_every=25", "run.ckpt_every=50",
                 "adapt.select_every=25"]
SCAN_CLI_INNER = 25
# (b) the throttle case starts from a critic trained ahead of the DAM
# (critic-only steps at lr_d 1e-3 with no cap, SCAN_AHEAD_CALL per call,
# until its d_acc reaches SCAN_AHEAD_ACC or SCAN_AHEAD_CALLS calls), so
# that the 0.9 cap holds steps
SCAN_CRITIC_AHEAD = ["adapt.lr_d=0.001", "adapt.d_acc_cap=1.0"]
SCAN_AHEAD_CALL, SCAN_AHEAD_CALLS, SCAN_AHEAD_ACC = 10, 30, 0.92


def _jax_rule_steps(n, k, every, start=0):
    """The steps at which the JAX package's loop logs a run of ``n`` train
    steps, ``k`` per call, from ``start``."""
    return [s for s in range(start + k - 1, n, k)
            if s % every < k or s >= n - k]


def _tensors_equal(torch, a, b):
    """(all leaves bitwise equal, number of leaves, the unequal ones)."""
    from mcmda_tpu_torch.utils import tree
    la, lb = tree.leaves(a), tree.leaves(b)
    bad = [i for i, (x, y) in enumerate(zip(la, lb))
           if x.dtype != y.dtype or not torch.equal(x, y)]
    return len(la) == len(lb) and not bad, len(la), bad


def _scan_compare(torch, counters, label, make, cfg, state0, data, per_step,
                  inner=SCAN_INNER, seed=4242):
    """``inner`` steps of ``make(cfg, sample_from_device=True)`` from
    ``state0`` through ``loop.scanned_step`` eagerly and on a CUDA graph
    with the same seed: states and the last metrics torch.equal.  The
    graph's call is traced: its one eager step and its capture go through
    the wrappers (2 x ``per_step``), its ``inner`` - 1 replays run
    ``per_step`` each on the device with no wrapper call.  Returns (graph
    step, eager step, the graph's state, what the call adds to the kernels
    line)."""
    from mcmda_tpu_torch.train import loop

    eager = loop.scanned_step(make(cfg, sample_from_device=True), inner)
    graph = loop.scanned_step(make(cfg, sample_from_device=True), inner,
                              graph=True, donate=cfg.run.donate)
    e_state, e_m = eager(state0, data, seed)
    (g_state, g_m), _, host, ran, replayed = traced_launches(
        torch, counters, lambda: graph(state0, data, seed))
    ok, n, bad = _tensors_equal(torch, g_state, e_state)
    m_ok = set(g_m) == set(e_m) and all(torch.equal(g_m[k], e_m[k])
                                        for k in g_m)
    st = graph.stats
    print(f"scan {label}: {inner} steps graph vs eager from one state: "
          f"{n} state tensors {'bitwise equal' if ok else f'DIFFER {bad}'}"
          f"; last metrics {'equal' if m_ok else 'DIFFER'} "
          f"({', '.join(f'{k} {float(v)!r}' for k, v in g_m.items())}); "
          "the graph's call (traced): "
          + _launch_text(counters, host, ran, replayed)
          + f"; capture {st['capture_s']:.2f} s under sync debug mode error"
          f" (0 host synchronisations); graph pool "
          f"{st['pool_bytes'] / 2**20:.1f} MiB", flush=True)
    if not ok or not m_ok:
        fail(f"scan {label}: graph and eager differ (tensors {bad}, "
             f"metrics {g_m} vs {e_m})")
    added = check_replays(f"scan {label}", host, replayed, per_step, inner)
    if not all(math.isfinite(float(v)) for v in g_m.values()):
        fail(f"scan {label}: metrics {g_m}")
    del e_state
    return graph, eager, g_state, added


def _scan_time(torch, label, step, state, data, make, cfg, graph: bool):
    """ms/step of ``step`` (SCAN_INNER steps per call; median of SCAN_TIMED
    calls; ``_scan_compare``'s call of it was the warm-up), then
    measure_step of SCAN_PROFILE-step calls of the same path.  Returns
    (dict, last state)."""
    from mcmda_tpu_torch.train import loop
    from mcmda_tpu_torch.utils import profiling

    times = []
    for i in range(SCAN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, data, 100 + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000 / SCAN_INNER)
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        fail(f"scan {label}: metrics {metrics}")
    short = loop.scanned_step(make(cfg, sample_from_device=True),
                              SCAN_PROFILE, graph=graph,
                              donate=cfg.run.donate)
    state, _ = short(state, data, 7)  # the capture, outside the profile
    prof = profiling.measure_step(short, state, data, n=1,
                                  inner_steps=SCAN_PROFILE)
    out = {"ms_per_step": statistics.median(times), "profile": prof}
    if graph:
        # the capture of one step, as in the timed graph, but untraced
        out["capture_s"] = short.stats["capture_s"]
        out["pool_mib"] = short.stats["pool_bytes"] / 2**20
    print(f"scan {label}: {out['ms_per_step']:.2f} ms/step (median of "
          f"{SCAN_TIMED} calls of {SCAN_INNER} after the warm-up call: "
          f"{[round(t, 2) for t in times]})", flush=True)
    print_profile(f"scan {label}", prof)
    del short
    return out, state


def phase_scan(torch, wk, tk, tmp):
    """Phase 14: the compiled multi-step dispatch on the card.  (d1)
    train-source through the CLI on the graph (25 steps per call), which is
    also the source of (b); (a) T1 and (b) adapt (mri2ct at rm3; ct2mri at
    rm2 with the throttle holding steps, and with dam_ema=0.5): 50 steps on
    the graph against 50 eager steps with the same seeds, bitwise; (c) both
    timed eager and on the graph; (d2) adapt through the CLI on the graph
    (log, probe and checkpoint steps, selection), and a train-source run
    stopped by SIGTERM and resumed, bitwise the uninterrupted run; (f) a
    one-rank NCCL step captured against its eager path.  The CLI runs of
    (d1) and (d2) and the graphs' calls of (a), (b) and (f) are traced
    (``traced_launches``).  Returns [warp, conv + moments]: the wrappers'
    launches of those runs, of (c)'s timed calls and of (d3), and the
    replays of the traced runs."""
    import contextlib
    import io
    import signal
    import threading
    import torch.distributed as dist
    from mcmda_tpu_torch import cli, weights
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.data import pipeline, synthetic, volumes
    from mcmda_tpu_torch.train import adapt, drivers, loop, source
    from mcmda_tpu_torch.utils import checkpoint, device as device_mod

    t_phase = time.perf_counter()
    device_mod.resolve(DEVICE, deterministic=True)
    torch.cuda.empty_cache()
    counters = (wk, tk)
    launches = [0, 0]
    card = device_mod.card()

    def count(added):
        launches[0] += added[0]
        launches[1] += added[1]

    def traced_cli(label, argv, n_steps, graphs, log):
        """``cli.main(argv)`` traced, its stdout into ``log``: (rc, wall
        s, the counts' text); ``n_steps`` steps on ``graphs`` graphs."""
        def run():
            with contextlib.redirect_stdout(log):
                return cli.main(argv)
        rc, wall, host, ran, replayed = traced_launches(torch, counters, run)
        count(check_replays(label, host, replayed, (1, 15), n_steps, graphs))
        return rc, wall, _launch_text(counters, host, ran, replayed)

    # (d1) train-source through the CLI, on the graph
    src = os.path.join(tmp, "scan-source")
    common = ["--config", CONFIG, "--synthetic", "--device", DEVICE]
    cli_sets = [a for kv in SCAN_CLI_SETS for a in ("--set", kv)]
    log = io.StringIO()
    n_src = 100
    rc, wall, counts = traced_cli(
        "scan (d) train-source", ["train-source", *common, *cli_sets,
                                  "--out", src], n_src, 1, log)
    text = log.getvalue()
    with open(os.path.join(src, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r["step"] for r in recs if "loss" in r]
    want = _jax_rule_steps(n_src, SCAN_CLI_INNER, 25)
    feed = [ln for ln in text.splitlines() if ln.startswith("feed path:")]
    print(f"scan (d) train-source via the CLI: {feed}; wall {wall:.1f} s; "
          f"loss steps {steps} (the JAX rule: {want}); val_dice steps "
          f"{[r['step'] for r in recs if 'val_dice' in r]}; {counts}; "
          "checkpoints "
          f"{sorted(n for n in os.listdir(src) if n.startswith('step_'))}",
          flush=True)
    if rc != 0 or steps != want or feed != [
            f"feed path: device-resident; {SCAN_CLI_INNER} steps per call "
            "on a CUDA graph"]:
        fail(f"scan (d) train-source: rc {rc}, steps {steps}, {feed}")

    marks = [("(d) train-source", time.perf_counter() - t_phase)]

    # (a) T1 on the graph against eager, then (c) both timed
    cfg = config_mod.load_config(CONFIG, ["segmenter.train_fused=pallas"])
    vols, labs = synthetic.make_dataset(0, "mri", 4, max(16, SIZE // 4), SIZE)
    data = pipeline.to_device_arrays(
        volumes.volumes_to_slices(vols, labs, context=3, drop_empty=True),
        cfg.data.num_classes, DEVICE)
    state0 = source.init_state(cfg.run.seed, cfg, DEVICE)
    graph, eager, state, added = _scan_compare(
        torch, counters, "(a) T1 mri2ct", source.make_train_step, cfg,
        state0, data, (1, 15))
    count(added)
    timing = {}
    wk.LAUNCHES = tk.LAUNCHES = 0
    timing["T1 eager"], _ = _scan_time(torch, "(c) T1 eager", eager, state0,
                                       data, source.make_train_step, cfg,
                                       False)
    timing["T1 graph"], _ = _scan_time(torch, "(c) T1 graph", graph, state,
                                       data, source.make_train_step, cfg,
                                       True)
    count((wk.LAUNCHES, tk.LAUNCHES))
    del graph, eager, state, state0
    marks.append(("(a) + (c) T1", time.perf_counter() - t_phase))

    # (b) adapt on the graph against eager: mri2ct rm3, ct2mri rm2 with the
    # throttle holding steps, ct2mri rm2 with the weight average
    mri_data, params, bn = adapt_setup(src, CONFIG)
    ct_data = {"src": mri_data["tgt"], "tgt": mri_data["src"]}
    cases = (("(b) adapt mri2ct rm3", CONFIG, [], mri_data, False),
             ("(b) adapt ct2mri rm2 throttle 0.9", CT2MRI, [], ct_data,
              True),
             ("(b) adapt ct2mri rm2 dam_ema=0.5", CT2MRI,
              ["adapt.dam_ema=0.5"], ct_data, False))
    for label, path, extra, adata, ahead in cases:
        acfg = config_mod.load_config(
            path, ["segmenter.train_fused=pallas", *extra])
        a0 = adapt.init_state(acfg.run.seed + 2, acfg, params, bn)
        if ahead:
            pre_cfg = config_mod.load_config(
                path, ["segmenter.train_fused=pallas", *SCAN_CRITIC_AHEAD])
            pre = loop.scanned_step(adapt.make_adapt_step(
                pre_cfg, train_g=False, sample_from_device=True),
                SCAN_AHEAD_CALL)
            accs = []
            for i in range(SCAN_AHEAD_CALLS):
                a0, pm = pre(a0, adata, 99 + i)
                accs.append(round(float(pm["d_acc"]), 4))
                if accs[-1] >= SCAN_AHEAD_ACC:
                    break
            print(f"scan {label}: the critic trained ahead, "
                  f"{SCAN_AHEAD_CALL} critic-only steps per call: d_acc "
                  f"{accs}", flush=True)
        c0 = int(a0.opt_d_state[0].count)
        graph, eager, state, added = _scan_compare(
            torch, counters, label, adapt.make_adapt_step, acfg, a0, adata,
            (1, 15))
        count(added)
        held = SCAN_INNER - (int(state.opt_d_state[0].count) - c0)
        print(f"scan {label}: the critic throttle (d_acc_cap "
              f"{acfg.adapt.d_acc_cap}) held {held} of {SCAN_INNER} steps",
              flush=True)
        if ahead and held < 1:
            fail(f"scan {label}: the throttle held no step")
        if path == CONFIG:
            wk.LAUNCHES = tk.LAUNCHES = 0
            timing["adapt eager"], _ = _scan_time(
                torch, "(c) adapt mri2ct rm3 eager", eager, a0, adata,
                adapt.make_adapt_step, acfg, False)
            timing["adapt graph"], _ = _scan_time(
                torch, "(c) adapt mri2ct rm3 graph", graph, state, adata,
                adapt.make_adapt_step, acfg, True)
            count((wk.LAUNCHES, tk.LAUNCHES))
        del graph, eager, state, a0

    marks.append(("(b) + (c) adapt", time.perf_counter() - t_phase))
    rows = []
    for name, t in timing.items():
        p = t["profile"]
        rows.append(f"{name} {t['ms_per_step']:.2f} ms/step, busy "
                    f"{p['device_busy_ms_per_step']:.2f} ms, idle "
                    f"{100 * p['idle_share']:.1f}%, host launches "
                    f"{p['host_launches_per_step']:.2f}/step"
                    + (f", capture {t['capture_s']:.2f} s, pool "
                       f"{t['pool_mib']:.0f} MiB" if "capture_s" in t
                       else ""))
    print(f"scan (c) on {card}: " + "; ".join(rows), flush=True)

    # (d2) adapt through the CLI on the graph
    ad = os.path.join(tmp, "scan-adapt")
    # the critic pretrain and the adaptation: a graph each
    rc, wall, counts = traced_cli(
        "scan (d) adapt", ["adapt", *common, *cli_sets, "--source-ckpt", src,
                           "--out", ad], 150, 2, io.StringIO())
    with open(os.path.join(ad, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r["step"] for r in recs if "d_loss" in r]
    want = (_jax_rule_steps(50, SCAN_CLI_INNER, 25)
            + _jax_rule_steps(150, SCAN_CLI_INNER, 25, start=50))
    probes = [r["step"] for r in recs if "class_ratio_dist" in r]
    with open(os.path.join(ad, "selection.json")) as f:
        best = json.load(f)["best_step"]
    names = sorted(os.listdir(ad))
    print(f"scan (d) adapt via the CLI: wall {wall:.1f} s; d_loss steps "
          f"{steps} (the JAX rule: {want}); probe steps {probes}; selected "
          f"step {best}; {counts}; wrote {names}", flush=True)
    if rc != 0 or steps != want or probes != list(range(75, 151, 25)) or \
            f"step_{best:08d}.npz" not in names:
        fail(f"scan (d) adapt: rc {rc}, steps {steps}, probes {probes}, "
             f"best {best}, {names}")

    # (d3) train-source stopped by SIGTERM once its step-50 checkpoint
    # exists (a watcher thread signals this process; the loop's guard
    # catches it), resumed, against (d1)'s uninterrupted run
    cut = os.path.join(tmp, "scan-source-cut")
    argv = ["train-source", *common, *cli_sets, "--out", cut]
    done = threading.Event()

    def watch():
        while not done.wait(0.01):
            if os.path.exists(os.path.join(cut, "step_00000050.npz")):
                os.kill(os.getpid(), signal.SIGTERM)
                return

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    # (not traced: the two runs' kernels are (d1)'s; the kernels line
    # takes their wrappers' launches)
    log = io.StringIO()
    wk.LAUNCHES = tk.LAUNCHES = 0
    try:
        with contextlib.redirect_stdout(log):
            rc_cut = cli.main(argv)
    finally:
        done.set()
        watcher.join()
    out = log.getvalue()
    stopped = [ln for ln in out.splitlines() if "preemption signal" in ln]
    kept = checkpoint.latest_step(cut)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    count((wk.LAUNCHES, tk.LAUNCHES))
    final = f"step_{n_src:08d}.npz"
    a = weights.read_checkpoint(os.path.join(src, final))
    b = weights.read_checkpoint(os.path.join(cut, final))
    same = set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    print(f"scan (d) train-source stopped by SIGTERM: {stopped}, latest "
          f"checkpoint {kept}; resumed to {n_src}: final checkpoint "
          f"{'bitwise equal to' if same else 'DIFFERS from'} the "
          f"uninterrupted run's; the two runs' wrapper launches warp "
          f"{wk.LAUNCHES}, conv_stats {tk.LAUNCHES}", flush=True)
    if len(stopped) != 1 or kept is None or kept >= n_src or rc_cut != 0 \
            or rc != 0 or not same:
        fail(f"scan (d) SIGTERM resume: {stopped}, kept {kept}, rc {rc}, "
             f"equal {same}")

    marks.append(("(d) adapt + SIGTERM", time.perf_counter() - t_phase))

    # (f) a one-rank NCCL group: the group's step captured
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        mode = drivers.dispatch(DEVICE, group)
        if mode != "graph":
            fail(f"scan (f): NCCL dispatch {mode}")

        def group_step(c, **kw):
            return source.make_train_step(c, group=group, **kw)

        state0 = source.init_state(cfg.run.seed, cfg, DEVICE)
        graph, eager, state, added = _scan_compare(
            torch, counters, "(f) T1 one-rank NCCL group", group_step, cfg,
            state0, data, (1, 15), inner=SCAN_NCCL)
        count(added)
        del graph, eager, state, state0
    finally:
        dist.destroy_process_group()
    marks.append(("(f) NCCL", time.perf_counter() - t_phase))
    print(f"scan phase: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} by {t:.1f} s" for k, t in marks)
          + f"); launches + replays warp {launches[0]}, conv_stats "
          f"{launches[1]}", flush=True)
    return launches


# phase 15: the last eager dispatch on CUDA graphs.  (a) runs HOST_STEPS
# steps of each host-sampler path (T1; adapt's critic pretrain and main
# step at rm3) through the API with the 1 GiB cutoff set to 0, on the graph
# and eagerly (``eager_dispatch``), then times each step on both: windows
# of HOST_TIMED steps (host clock around next(feed) + step, synchronised at
# the window's ends) in the order eager, graph, graph, eager after a
# warm-up window each.  (b) serves SERVE_TIMED volumes per path, (c) runs
# PROBE_TIMED ticks per path, in turns after a warm-up; (d) runs the sweep
# for GRAPH_SWEEP_ADAPT steps; (e) NCCL_STEPS steps.
HOST_STEPS = 20
HOST_TIMED = 5
GRAPH_SWEEP_ADAPT = 20
HOST_SETS = ["segmenter.train_fused=pallas", "run.log_every=1",
             f"source.steps={HOST_STEPS}", f"adapt.pretrain_steps={HOST_STEPS}",
             f"adapt.steps={HOST_STEPS}"]
SERVE_TIMED = 5
PROBE_TIMED = 5
NCCL_STEPS = 10


@contextlib.contextmanager
def eager_dispatch():
    """Inside the block ``drivers.dispatch`` says "eager", so every path
    that takes a CUDA graph on the card runs its eager twin instead: what
    the graph is held to here.  The port itself never falls back."""
    from mcmda_tpu_torch.train import drivers

    real = drivers.dispatch
    drivers.dispatch = lambda *a, **k: "eager"
    try:
        yield
    finally:
        drivers.dispatch = real


def _turns(torch, paths, run, warm, timed):
    """ms of ``run(path)`` (host clock, synchronised) per path: ``warm``
    calls of each, then ``timed`` rounds of the paths in turns, the order
    reversed every round.  Returns {path: [ms, ...]}."""
    for p in paths:
        for _ in range(warm):
            run(p)
    times = {p: [] for p in paths}
    for i in range(timed):
        for p in (paths if i % 2 == 0 else paths[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(p)
            torch.cuda.synchronize()
            times[p].append((time.perf_counter() - t0) * 1000)
    return times


def _profile_text(m: dict) -> str:
    return (f"busy {m['device_busy_ms_per_step']:.2f} ms, idle "
            f"{100 * m['idle_share']:.1f}%, host launch calls "
            f"{m['host_launches_per_step']:.1f}")


def phase_graphs(torch, wk, tk, fk, cfg_eval, tmp, card):
    """Phase 15: the host-sampler steps, serving's one-dispatch volume,
    the class-ratio probe and the sweep's probes on CUDA graphs, each
    against its eager twin (bitwise) and timed both ways, and the
    host-sampler graph in a one-rank NCCL group.  See the module
    docstring.  Returns [warp, conv + moments, fused conv]: the wrappers'
    launches of the phase (eager runs, warm-ups and captures; the replays
    are not counted)."""
    import io
    import torch.distributed as dist
    from mcmda_tpu_torch import api, cli
    from mcmda_tpu_torch import config as config_mod
    from mcmda_tpu_torch.data import pipeline, synthetic, volumes
    from mcmda_tpu_torch.evaluation import inference
    from mcmda_tpu_torch.scripts import seed_sweep
    from mcmda_tpu_torch.train import adapt, drivers, source
    from mcmda_tpu_torch.utils import cuda_graph, device as device_mod, \
        prng, profiling

    t_phase = time.perf_counter()
    device_mod.resolve(DEVICE, deterministic=True)
    torch.cuda.empty_cache()
    wk.LAUNCHES = tk.LAUNCHES = fk.LAUNCHES = 0
    marks = []
    graph_line = "feed path: host-sampler; one step per call on a CUDA graph"
    eager_line = "feed path: host-sampler; one eager step per call"

    # (a) the host-sampler steps through the API, on the graph and eager
    cfg = config_mod.load_config(CONFIG, HOST_SETS)
    depth = max(16, SIZE // 4)
    sv, sl = synthetic.make_dataset(0, "mri", 4, depth, SIZE)
    tv, _ = synthetic.make_dataset(0, "ct", 4, depth, SIZE)
    runs = {}
    real_cutoff = api._ON_DEVICE_BYTES
    api._ON_DEVICE_BYTES = 0
    try:
        for mode in ("graph", "eager"):
            out = os.path.join(tmp, f"graphs-{mode}")
            log = io.StringIO()
            ctx = eager_dispatch() if mode == "eager" else \
                contextlib.nullcontext()
            t0 = time.perf_counter()
            with ctx, contextlib.redirect_stdout(log):
                src = api.train_source(cfg, sv, sl, out_dir=out + "-src",
                                       device=DEVICE)
                ad = api.adapt(cfg, src, sv, sl, tv[:-1], out_dir=out + "-ad")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            files = {}  # every record but its wall time
            for run in ("src", "ad"):
                for name in ("metrics.jsonl", "selection.json"):
                    path = os.path.join(f"{out}-{run}", name)
                    if os.path.exists(path):
                        with open(path) as f:
                            files[f"{run}/{name}"] = [
                                {k: v for k, v in json.loads(ln).items()
                                 if k != "wall"} for ln in f if ln.strip()]
            lines = log.getvalue().splitlines()
            runs[mode] = (src, ad, files, [ln for ln in lines
                                           if ln.startswith("feed path:")])
            print(f"graphs (a) api host-sampler {mode}: T1 {HOST_STEPS} + "
                  f"pretrain {HOST_STEPS} + adapt {HOST_STEPS} steps (probe "
                  f"every {api._select_every(cfg, HOST_STEPS)}) in {wall:.1f}"
                  f" s; {runs[mode][3]}; "
                  + "; ".join(ln for ln in lines if ln.startswith("[graph]")),
                  flush=True)
    finally:
        api._ON_DEVICE_BYTES = real_cutoff
    (g_src, g_ad, g_files, g_feed), (e_src, e_ad, e_files, e_feed) = \
        runs["graph"], runs["eager"]
    same_src, n_src, bad_src = _tensors_equal(torch, g_src, e_src)
    same_ad, n_ad, bad_ad = _tensors_equal(torch, g_ad, e_ad)
    same_files = g_files == e_files and len(g_files) == 3
    print(f"graphs (a) api host-sampler graph vs eager: T1 {n_src} state "
          f"tensors {'bitwise equal' if same_src else f'DIFFER {bad_src}'}; "
          f"adapt {n_ad} {'bitwise equal' if same_ad else f'DIFFER {bad_ad}'}"
          f"; metrics.jsonl (every step's metrics) and selection.json "
          f"{'equal' if same_files else 'DIFFER'} ({sorted(g_files)})",
          flush=True)
    if not (same_src and same_ad and same_files):
        fail("graphs (a): the host-sampler graph and eager runs differ")
    if g_feed != [graph_line] * 2 or e_feed != [eager_line] * 2:
        fail(f"graphs (a): feed lines {g_feed} / {e_feed}")

    src_ds = volumes.volumes_to_slices(sv, sl, context=3, drop_empty=True)
    tgt_ds = volumes.volumes_to_slices(tv[:-1], context=3)

    def t1_stream():
        return iter(pipeline.BatchSampler(src_ds, BATCH, seed=1,
                                          num_classes=cfg.data.num_classes))

    def adapt_stream():
        return ({"src_image": a["image"], "tgt_image": b["image"]}
                for a, b in zip(pipeline.BatchSampler(src_ds, BATCH, seed=3),
                                pipeline.BatchSampler(tgt_ds, BATCH, seed=4)))

    a0 = adapt.init_state(cfg.run.seed + 2, cfg, g_src.params,
                          g_src.bn_state)
    rows = []
    for label, make, kw, state0, stream in (
            ("T1", source.make_train_step, {}, g_src, t1_stream),
            ("adapt pretrain", adapt.make_adapt_step, {"train_g": False}, a0,
             adapt_stream),
            ("adapt rm3", adapt.make_adapt_step, {}, a0, adapt_stream)):
        steps = {"graph": drivers.wrap_dp(cfg, make, device=DEVICE, **kw)[0]}
        with eager_dispatch():
            steps["eager"] = drivers.wrap_dp(cfg, make, device=DEVICE,
                                             **kw)[0]
        feeds = {m: drivers.feed(stream(), DEVICE) for m in steps}
        states = dict.fromkeys(steps, state0)

        def window(m):
            for i in range(HOST_TIMED):
                states[m], _ = steps[m](states[m], next(feeds[m]), i)

        times = _turns(torch, ("eager", "graph"), window, 1, 2)
        prof = {m: profiling.measure_step(steps[m], states[m], feeds[m], n=5)
                for m in steps}
        st = steps["graph"].stats
        med = {m: statistics.median(t) / HOST_TIMED for m, t in times.items()}
        rows.append(f"{label} eager {med['eager']:.2f} / graph "
                    f"{med['graph']:.2f} ms/step")
        print(f"graphs (a) host-sampler {label} step, prefetched feed, on "
              f"{card}: ms/step eager "
              f"{[round(t / HOST_TIMED, 2) for t in times['eager']]}, graph "
              f"{[round(t / HOST_TIMED, 2) for t in times['graph']]} (windows"
              f" of {HOST_TIMED} steps in turns); measure_step eager "
              f"{prof['eager']['host_ms_per_step']:.2f} ms/step, "
              f"{_profile_text(prof['eager'])}; graph "
              f"{prof['graph']['host_ms_per_step']:.2f} ms/step, "
              f"{_profile_text(prof['graph'])}; capture "
              f"{st['capture_s']:.2f} s, graph pool "
              f"{st['pool_bytes'] / 2**20:.0f} MiB", flush=True)
        del steps, feeds, states
    del a0, runs, g_src, e_src, e_ad
    torch.cuda.empty_cache()
    marks.append(("(a) host-sampler", time.perf_counter() - t_phase))

    # (b) serving: predict_volume's one graph against its batch loop
    src, ada, vol_path = write_inputs(cfg_eval,
                                      os.path.join(tmp, "graphs-serve"), torch)
    vol = volumes.normalize_volume(
        volumes.load_volume_with_spacing(vol_path)[0])
    device = torch.device(DEVICE)
    sets = [a for kv in SETS for a in ("--set", kv)]
    for name, extra, _ in RUNS:
        ckpt = src if "--source-only" in extra else ada
        argv = ["predict", "--config", CONFIG, *sets, "--ckpt",
                os.path.dirname(ckpt), "--input", vol_path, "--device",
                DEVICE, *extra]
        args = cli.build_parser().parse_args(argv + ["--out", tmp])
        args.ckpt = cli._resolve_ckpt(args.ckpt)
        ecfg = config_mod.load_config(args.config, args.set)
        tta = inference.get_tta(args.tta or ecfg.run.eval_tta) or \
            (lambda f: f)
        fwd = tta(cli._restore_eval_forward(ecfg, args, device, True))
        masks = {}

        def serve(sd):
            masks[sd] = inference.predict_volume(
                fwd, vol, context=3, batch_size=BATCH, device=device,
                single_dispatch=sd)

        times = _turns(torch, (False, True), serve, 1, SERVE_TIMED)
        runner = inference._scanned_argmax(
            fwd, (tuple(vol.shape), device, True), 3, BATCH)
        prof = {sd: profiling.measure_step(
            lambda st, v, _s, sd=sd: (st, serve(sd)), None, vol, n=3)
            for sd in (False, True)}
        walls, cli_masks = {}, {}
        for mode in ("graph", "eager"):
            out = os.path.join(tmp, f"serve-{name}-{mode}".replace(" ", "_"))
            ctx = eager_dispatch() if mode == "eager" else \
                contextlib.nullcontext()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx, contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(argv + ["--out", out])
            walls[mode] = time.perf_counter() - t0
            cli_masks[mode] = volumes.load_volume_with_spacing(
                os.path.join(out, "case1_pred.nii.gz"))[0]
            if rc != 0:
                fail(f"graphs (b) predict {name} {mode}: rc {rc}")
        same = np.array_equal(masks[True], masks[False])
        same_cli = np.array_equal(cli_masks["graph"], cli_masks["eager"])
        print(f"graphs (b) serving {name}: {SLICES}-slice volume masks, one "
              f"graph vs the batch loop {'equal' if same else 'DIFFER'}, the"
              f" CLI graph vs eager {'equal' if same_cli else 'DIFFER'}; on "
              f"{card}: ms/volume batch loop "
              f"{[round(t, 2) for t in times[False]]} (median "
              f"{statistics.median(times[False]):.2f}), graph "
              f"{[round(t, 2) for t in times[True]]} (median "
              f"{statistics.median(times[True]):.2f}); measure_step loop "
              f"{_profile_text(prof[False])}, graph "
              f"{_profile_text(prof[True])} (per volume); CLI predict wall "
              f"graph {walls['graph']:.2f} s, eager {walls['eager']:.2f} s; "
              f"capture {runner.stats['capture_s']:.2f} s, pool growth "
              f"{runner.stats['pool_bytes'] / 2**20:.0f} MiB", flush=True)
        if not (same and same_cli) or masks[True].shape != vol.shape:
            fail(f"graphs (b) serving {name}: masks differ")
        rows.append(f"serving {name} loop "
                    f"{statistics.median(times[False]):.2f} / graph "
                    f"{statistics.median(times[True]):.2f} ms/volume")
        del fwd, runner
    inference._scan_cache.clear()
    inference._tta_cache.clear()
    marks.append(("(b) serving", time.perf_counter() - t_phase))

    # (c) one selection tick (make_select_bundle: the probe and the weight
    # copies) on the graph against eager, on (a)'s adapted state
    probe_images = api._probe_images(tgt_ds)
    bundles = {"graph": adapt.make_select_bundle(cfg, probe_images)}
    ticks = {}
    with eager_dispatch():  # the probe picks its dispatch at its first call
        bundles["eager"] = adapt.make_select_bundle(cfg, probe_images)
        ticks["eager"] = bundles["eager"](g_ad)

    def tick(m):
        ticks[m] = bundles[m](g_ad)

    times = _turns(torch, ("eager", "graph"), tick, 1, PROBE_TIMED)
    prof = {m: profiling.measure_step(
        lambda st, _d, _s, m=m: (st, bundles[m](st)), g_ad, None, n=3)
        for m in bundles}
    same = all(torch.equal(ticks["graph"][k], ticks["eager"][k])
               for k in ("fracs_live", "ent_live"))
    print(f"graphs (c) selection tick ({len(probe_images)} target slices, "
          f"batch {cfg.data.batch_size}): graph vs eager fractions "
          f"{ticks['graph']['fracs_live'].tolist()} and entropy "
          f"{float(ticks['graph']['ent_live'])!r} "
          f"{'bitwise equal' if same else 'DIFFER'}; on {card}: ms/tick "
          f"eager {[round(t, 2) for t in times['eager']]}, graph "
          f"{[round(t, 2) for t in times['graph']]}; measure_step eager "
          f"{_profile_text(prof['eager'])}, graph "
          f"{_profile_text(prof['graph'])} (per tick)", flush=True)
    if not same:
        fail(f"graphs (c): probe graph {ticks['graph']} vs eager "
             f"{ticks['eager']}")
    rows.append(f"probe tick eager {statistics.median(times['eager']):.2f} / "
                f"graph {statistics.median(times['graph']):.2f} ms")
    del bundles, ticks, g_ad
    marks.append(("(c) probe", time.perf_counter() - t_phase))

    # (d) the sweep's probes (live, flip TTA, the in-state EMA) at toy
    # length, the whole sweep on the graph against eager
    arts = {}
    for mode in ("graph", "eager"):
        ctx = eager_dispatch() if mode == "eager" else \
            contextlib.nullcontext()
        path = os.path.join(tmp, f"graphs-sweep-{mode}.json")
        with ctx, contextlib.redirect_stdout(io.StringIO()):
            arts[mode] = seed_sweep.main([
                *SWEEP_ARGS, "--adapt-steps", str(GRAPH_SWEEP_ADAPT),
                "--seeds", "1", "--set", "adapt.dam_ema=0.5", "--out", path])
    curves = {m: json.loads(json.dumps(a["curves"])) for m, a in arts.items()}
    rows_eq = json.loads(json.dumps(arts["graph"]["per_seed"])) == \
        json.loads(json.dumps(arts["eager"]["per_seed"]))
    recs = curves["graph"]["0"]
    variants = [k for k in ("dice", "dice_tta", "dice_state_ema")
                if all(k in r for r in recs)]
    print(f"graphs (d) seed sweep at toy length, dispatch "
          f"{arts['graph']['settings']['dispatch']} vs "
          f"{arts['eager']['settings']['dispatch']}: {len(recs)} probe ticks"
          f" of {variants}; curves "
          f"{'equal' if curves['graph'] == curves['eager'] else 'DIFFER'}, "
          f"per-seed rows {'equal' if rows_eq else 'DIFFER'}; live Dice "
          f"{[r['dice'] for r in recs]}", flush=True)
    if curves["graph"] != curves["eager"] or not rows_eq or \
            len(variants) != 3 or not arts["graph"]["settings"][
                "dispatch"]["graph"]:
        fail("graphs (d): the sweep's probes differ between graph and eager")
    marks.append(("(d) sweep", time.perf_counter() - t_phase))

    # (e) a one-rank NCCL group: the host-sampler graph against one process
    # (the group's step folds its rank, 0, into each step's seed)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        step = drivers._step(cfg, source.make_train_step, group,
                             wrap=drivers._host_graph(cfg, DEVICE, group))
        one = source.make_train_step(cfg)
        state0 = source.init_state(cfg.run.seed, cfg, DEVICE)
        feeds = [drivers.feed(t1_stream(), DEVICE) for _ in range(2)]
        g_st, o_st = state0, state0
        for i in range(NCCL_STEPS):
            g_st, g_m = step(g_st, next(feeds[0]), 500 + i)
            o_st, o_m = one(o_st, next(feeds[1]), prng.fold_in(500 + i, 0))
        ok, n, bad = _tensors_equal(torch, g_st, o_st)
        m_ok = set(g_m) == set(o_m) and all(float(g_m[k]) == float(o_m[k])
                                            for k in g_m)
        print(f"graphs (e) one-rank NCCL group, host-sampler T1 on the graph"
              f" (dispatch {drivers.dispatch(DEVICE, group)}), {NCCL_STEPS} "
              f"steps against one process: {n} state tensors "
              f"{'bitwise equal' if ok else f'DIFFER {bad}'}, last metrics "
              f"{'equal' if m_ok else 'DIFFER'}", flush=True)
        if not ok or not m_ok:
            fail(f"graphs (e): NCCL graph vs one process ({bad}, {g_m} vs "
                 f"{o_m})")
        del step, g_st, o_st, state0
    finally:
        dist.destroy_process_group()
    marks.append(("(e) NCCL", time.perf_counter() - t_phase))

    # (f) no fallback: a capture that would wait on the host raises, and so
    # does a fed batch of another shape
    def synced(x):
        return x * float(x.sum())

    raised = []
    try:
        cuda_graph.GraphedCall(synced, lambda x: x, DEVICE)(
            torch.ones(8, device=DEVICE))
    except RuntimeError as e:
        raised.append(f"RuntimeError ({str(e).splitlines()[0][:80]})")
    fed = cuda_graph.GraphedSteps(
        lambda st, b, g: ({"w": st["w"] + b["x"].sum()}, {}), 1, fed=True)
    st, _ = fed({"w": torch.zeros((), device=DEVICE)},
                {"x": torch.ones(4, device=DEVICE)}, 1)
    try:
        fed(st, {"x": torch.ones(5, device=DEVICE)}, 2)
    except ValueError as e:
        raised.append(f"ValueError ({str(e)[:60]}...)")
    print(f"graphs (f) a capture with a host sync: {raised[:1]}; a fed "
          f"batch of another shape: {raised[1:]}", flush=True)
    if len(raised) != 2 or not raised[0].startswith("RuntimeError"):
        fail(f"graphs (f): expected two errors, got {raised}")
    print(f"graphs on {card}: " + "; ".join(rows), flush=True)
    launches = [wk.LAUNCHES, tk.LAUNCHES, fk.LAUNCHES]
    print(f"graphs phase: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} by {t:.1f} s" for k, t in marks)
          + f"); wrapper launches warp {launches[0]}, conv_stats "
          f"{launches[1]}, fused conv {launches[2]}", flush=True)
    return launches


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

        # 12. data parallelism: 2 ranks over gloo, the CLI, NCCL
        dp_w, dp_c = phase_dp(torch, wk, tk, tmp)
        warp_launches += dp_w
        conv_launches += dp_c

        # 13. the ct2mri recipe and the plug-depth ablation twin
        ct_w, ct_c, ct_f = phase_ct2mri(torch, wk, tk, fk, tmp, n_sites,
                                        adapt_ms)
        warp_launches += ct_w
        conv_launches += ct_c
        launches += ct_f

        # 14. the compiled multi-step dispatch: CUDA graphs of the steps
        sc_w, sc_c = phase_scan(torch, wk, tk, tmp)
        warp_launches += sc_w
        conv_launches += sc_c

        # 15. the last eager dispatch on CUDA graphs
        gr_w, gr_c, gr_f = phase_graphs(torch, wk, tk, fk, cfg, tmp,
                                        device_mod.card())
        warp_launches += gr_w
        conv_launches += gr_c
        launches += gr_f

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
