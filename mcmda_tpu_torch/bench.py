"""Benchmark of the port on one NVIDIA GPU: the twin of the JAX package's
``bench.py``, with the kernel-path comparisons of its two companions
(``scripts/bench_train_fused.py``, ``scripts/bench_serving_paths.py``)
folded in::

    python -m mcmda_tpu_torch.bench [--calls N] [--steps K]

It runs ``bench.py``'s configuration: the default ``ExperimentConfig``
with the warp kernel (``data.warp="pallas"``) and the bf16 frozen source
forward (``adapt.src_feats_bf16``); batch 8 of [256,256,3] slices, 5
classes; the segmenter and the critic from their initialisers (seeded
torch generators; inputs from seeded numpy), no checkpoint.

- Steps: the adapt step and the source step on a CUDA graph of one step
  replayed K (50) times per call (``loop.scanned_step(graph=True,
  donate=True)``) on a fixed device batch, the state chained from call to
  call as ``bench.py``'s scan carry is; one warm-up call (the capture),
  then N (5) calls, each timed with CUDA events; ms/step is the median
  call over K.  The headline runs the train forward's convs on cuDNN
  (``segmenter.train_fused="none"``); the same steps run eagerly
  (``*_eager``) and on the kernel path (``train_fused="pallas"``: the
  conv + BN-moments kernel, ``*_kernel_path``).
- ``dispatch_floor_ms``: the median wall time of a one-step graph call
  (host clock, synchronised) minus the adapt step's ms/step: the fixed
  cost of a call.
- FLOPs per step (``step_flops``): one eager headline step under
  ``FlopCounterMode`` with XLA's ``HloCostAnalysis`` convention, which gave
  ``bench.py``'s figure: 2 per multiply-add of every convolution and
  matrix product, a conv tap only where it falls inside the input, and
  elementwise work not counted.  The kernel path does the same math and
  takes the same count: its kernels are opaque to the counter, whose count
  would drop there.
- MFU: FLOPs per step / step time / the bf16 matmul peak measured here
  (``bench.py``'s definition; the train path is f32, so the share is small
  by design).  Peaks: chained 4096^3 ``torch.matmul`` in bf16 and in f32
  (TF32 off, as ``device.resolve`` pins it: the CUDA cores' f32 rate); HBM:
  a chained in-place multiply-add over 256 MiB of f32.
- Device busy and idle share: ``profiling.measure_step`` of a graph of
  ``PROFILE_STEPS`` steps.
- Serving: a 64x256x256 volume on the card through
  ``inference._scanned_argmax``'s CUDA graph (it reads device inputs in
  place), ``segmenter.apply`` in f32 and bf16, and the fused conv kernel's
  ``apply_fused_eval`` (``serving_fused_*``); the median of N volumes.
  ``predict_volume`` end to end (upload and readback included): the first
  call, which captures, and the warm median of N.

Checks, before any timing, each raising: the kernel path's step-1 losses
against the headline's from one state, batch and seed (``STEP1_RTOL``),
and the fused serving masks against ``apply``'s (``AGREE``).  A share
(``*_mfu_*``, ``*_utilization_*``) over ``MAX_SHARE`` raises: it can only
be a counting or timing fault.

The last line of the output is one JSON object, ``{"metric", "value",
"unit", "vs_baseline", "extra"}``; ``extra`` holds every key of
``bench.py``'s (``BENCH_PY_KEYS``) and the port's own.  ``bench.py``'s XLA
estimates have no counterpart (no XLA) and are null, as are the measured
HBM bytes: ``torch.profiler`` reads no DRAM counters.  Without a CUDA
device it prints ``bench.py``'s error line and exits 2: every timing
helper raises on a CPU tensor, and nothing here runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from mcmda_tpu_torch.config import ExperimentConfig
from mcmda_tpu_torch.evaluation import inference
from mcmda_tpu_torch.kernels import fused_conv, train_conv, warp
from mcmda_tpu_torch.models import segmenter
from mcmda_tpu_torch.train import adapt, loop, source
from mcmda_tpu_torch.utils import device as device_mod
from mcmda_tpu_torch.utils import prng, profiling, tree

METRIC = "adapt_train_slices_per_sec_per_chip"
UNIT = "slices/s/chip"
# the keys of bench.py's ``extra``, every one of which the port prints
BENCH_PY_KEYS = (
    "adapt_step_ms", "adapt_flops_per_step", "adapt_tflops_per_sec",
    "adapt_mfu_vs_measured_peak", "adapt_hbm_bytes_xla_estimate",
    "adapt_hbm_bw_utilization_xla_estimate", "adapt_hbm_bytes_measured",
    "adapt_hbm_gbps_measured", "adapt_hbm_bw_utilization_measured",
    "source_train_slices_per_sec", "source_step_ms", "source_tflops_per_sec",
    "source_mfu_vs_measured_peak", "source_hbm_bytes_xla_estimate",
    "source_hbm_bw_utilization_xla_estimate", "serving_slices_per_sec",
    "serving_bf16_slices_per_sec", "serving_volume_ms",
    "serving_volume_ms_is_marginal", "serving_e2e_volume_ms",
    "measured_peak_tflops", "measured_peak_tflops_f32", "measured_hbm_gbps",
    "dispatch_floor_ms")
CALLS = 5            # timed calls per figure, after one warm-up call
STEPS = 50           # train steps per graph call (the CLI's pick_inner)
PROFILE_STEPS = 5    # steps of the graph that measure_step traces
FLOOR_CALLS = 20     # one-step graph calls behind dispatch_floor_ms
SLICES = 64          # the serving volume's slices
MATMUL_N = 4096
MATMUL_LINKS = 64
HBM_ELEMENTS = 1 << 26   # 256 MiB of f32
HBM_LINKS = 64
STEP1_RTOL = 5e-4    # kernel path / headline, step-1 losses
AGREE = {"float32": 0.999, "bfloat16": 0.995}  # fused / plain masks
MAX_SHARE = 1.05
STEP1_LOSSES = {"adapt": ("d_loss", "g_loss"),
                "source": ("loss", "xent", "dice_loss")}


def reference_baseline() -> float:
    """The ``vs_baseline`` denominator, slices/s, as ``bench.py`` reads it:
    ``results/reference_baseline.json`` (a torch-CPU reimplementation of
    the reference's TF1 training step), else that script's recorded r1
    figure."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results", "reference_baseline.json")
    try:
        with open(path) as f:
            return float(json.load(f)["slices_per_sec"])
    except (OSError, KeyError, ValueError):
        return 0.207


# ------------------------------------------------------------- configuration
def bench_config() -> ExperimentConfig:
    """``bench.py``'s configuration: the defaults with the warp kernel and
    the bf16 frozen source forward."""
    cfg = ExperimentConfig()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, warp="pallas"),
        adapt=dataclasses.replace(cfg.adapt, src_feats_bf16=True))


def kernel_path(cfg: ExperimentConfig) -> ExperimentConfig:
    """``cfg`` with the train forward's conv + BN-moments kernel."""
    return dataclasses.replace(cfg, segmenter=dataclasses.replace(
        cfg.segmenter, train_fused="pallas"))


def check_same_math(head: ExperimentConfig, kern: ExperimentConfig) -> None:
    """Raise unless the two configurations differ in
    ``segmenter.train_fused`` alone: then they compute the same step, and
    the headline's FLOP count is the kernel path's too."""
    back = dataclasses.replace(kern, segmenter=dataclasses.replace(
        kern.segmenter, train_fused=head.segmenter.train_fused))
    if back != head or kern.segmenter.train_fused != "pallas" \
            or head.segmenter.train_fused == "pallas":
        raise ValueError("the kernel path must differ from the headline in "
                         "segmenter.train_fused alone")


def eval_forward(seg_cfg, fused: bool):
    """``(images, params, bn) -> probs`` in eval mode: ``apply`` or, with
    ``fused``, ``apply_fused_eval`` (the fused conv kernel on the card).
    A new function object at each call, so that each keeps graphs of its
    own in ``inference``'s cache."""
    if fused:
        return lambda x, p, b: segmenter.apply_fused_eval(p, b, x,
                                                          seg_cfg)[1]
    return lambda x, p, b: segmenter.apply(p, b, x, seg_cfg)[1]


# ------------------------------------------------------------------- FLOPs
_aten = torch.ops.aten


def _valid_taps(n_in: int, n_out: int, k: int, stride: int, pad_lo: int,
                dilation: int) -> int:
    """(output position, tap) pairs of one spatial dimension whose input
    index ``o * stride + t * dilation - pad_lo`` falls inside
    ``[0, n_in)``: the positions XLA's ``HloCostAnalysis`` counts."""
    n = 0
    for t in range(k):
        off = t * dilation - pad_lo
        lo = max(0, -(off // stride))             # first o with o*s+off >= 0
        hi = min(n_out, (n_in - 1 - off) // stride + 1) if n_in > off \
            else 0
        n += max(0, hi - lo)
    return n


class _TapCounter:
    """The ``custom_mapping`` of ``FlopCounterMode`` for the valid-tap
    convention.  A conv's input may be an explicit zero pad of the image
    (``layers.conv_apply`` pads XLA's asymmetric SAME that way): the pad's
    output is remembered, and its rows and columns count as outside the
    image in the conv and in its backward, which gets the same tensor."""

    def __init__(self):
        self.pads = WeakIdKeyDictionary()

    def mapping(self) -> dict:
        def raw(method):  # FlopCounterMode passes tensors, not shapes
            def fn(*args, **kwargs):
                return method(*args, **kwargs)
            fn._get_raw = True
            return fn
        return {_aten.constant_pad_nd: raw(self._pad),
                _aten.convolution: raw(self._conv),
                _aten._convolution: raw(self._conv),
                _aten.convolution_backward: raw(self._conv_backward)}

    def _pad(self, x, pad, value=0.0, *, out_val):
        pad = list(pad)
        if value == 0 and all(p >= 0 for p in pad):
            prev = self.pads.get(x, {})
            got = dict(prev)
            for i in range(len(pad) // 2):
                dim = x.dim() - 1 - i
                lo, hi = prev.get(dim, (0, 0))
                got[dim] = (lo + pad[2 * i], hi + pad[2 * i + 1])
            self.pads[out_val] = got
        return 0

    def _flops(self, x, w, stride, padding, dilation, out_hw) -> int:
        pads = self.pads.get(x, {})
        n = 2 * x.shape[0] * w.shape[0] * w.shape[1]
        for i, n_out in enumerate(out_hw):
            lo, hi = pads.get(2 + i, (0, 0))
            n *= _valid_taps(x.shape[2 + i] - lo - hi, n_out, w.shape[2 + i],
                             stride[i], padding[i] + lo, dilation[i])
        return n

    def _conv(self, x, w, bias, stride, padding, dilation, transposed,
              output_padding, groups, *rest, out_val):
        if transposed:
            raise ValueError("the valid-tap count has no transposed conv")
        return self._flops(x, w, stride, padding, dilation, out_val.shape[2:])

    def _conv_backward(self, grad_out, x, w, bias_sizes, stride, padding,
                       dilation, transposed, output_padding, groups,
                       output_mask, *, out_val):
        if transposed:
            raise ValueError("the valid-tap count has no transposed conv")
        # the input and the weight gradient each visit every valid tap once
        per = self._flops(x, w, stride, padding, dilation, grad_out.shape[2:])
        return per * (int(output_mask[0]) + int(output_mask[1]))


def step_flops(step, state, batch, seed: int = 0) -> int:
    """FLOPs of one eager call ``step(state, batch, seed)`` under the
    valid-tap convention (see ``_TapCounter``): convolutions, their
    backward as autograd runs it (no weight gradient of a frozen tensor,
    no input gradient of the image) and the matrix products, 2 per
    multiply-add.  Run it where every conv is an aten conv: the
    hand-written kernels are opaque to the counter."""
    counter = FlopCounterMode(display=False,
                              custom_mapping=_TapCounter().mapping())
    with counter:
        step(state, batch, seed)
    return int(counter.get_total_flops())


# ------------------------------------------------------------------ timing
def _on_card(*trees) -> None:
    """Raise unless every tensor of ``trees`` lies on a CUDA device: the
    bench times the card, never the CPU."""
    for t in tree.leaves(trees):
        if not t.is_cuda:
            raise ValueError(f"the bench times a CUDA device, not a tensor "
                             f"on {t.device}")


def _finite(label: str, metrics: dict) -> None:
    bad = {k: float(v) for k, v in metrics.items()
           if not math.isfinite(float(v))}
    if bad:
        raise RuntimeError(f"{label}: metrics not finite: {bad}")


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _event_ms(fn, calls: int):
    """Milliseconds of each of ``calls`` calls ``fn()``, each between two
    CUDA events on the current stream; synchronises once at the end.
    Returns (times, the last call's result)."""
    marks, out = [], None
    for _ in range(calls):
        start, end = _events()
        start.record()
        out = fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in marks], out


def _wall_ms(fn, calls: int):
    """Host wall milliseconds of each of ``calls`` calls ``fn()``, each
    between two synchronisations of the device."""
    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


class _Chained:
    """Calls of ``step(state, batch, seed)``, each on the state the last
    returned (``bench.py``'s scan carry): a warm-up call with seed 0 when
    made (on a graph, the capture), then seeds 1, 2, ... ."""

    def __init__(self, step, state, batch):
        _on_card(state, batch)
        self.step, self.batch, self.seed = step, batch, 0
        self.state, self.metrics = step(state, batch, 0)

    def __call__(self):
        self.seed += 1
        self.state, self.metrics = self.step(self.state, self.batch,
                                             self.seed)


def time_steps(step, state, batch, calls: int, steps: int) -> list:
    """ms per train step of each of ``calls`` chained calls of ``step``
    (``steps`` train steps each, a ``loop.scanned_step``) after the
    warm-up call, CUDA events."""
    chained = _Chained(step, state, batch)
    ms, _ = _event_ms(chained, calls)
    _finite("timed step", chained.metrics)
    return [t / steps for t in ms]


def call_floor_ms(step, state, batch, calls: int) -> list:
    """Host wall ms of each of ``calls`` chained calls of ``step`` after
    the warm-up call."""
    return _wall_ms(_Chained(step, state, batch), calls)


def busy(step, state, batch, steps: int) -> dict:
    """``profiling.measure_step`` of one call of ``step`` (``steps`` train
    steps), after the warm-up call, which captures it outside the trace."""
    chained = _Chained(step, state, batch)
    return profiling.measure_step(step, chained.state, batch, n=1,
                                  inner_steps=steps)


def time_volumes(run, vol, fwd_args, calls: int):
    """ms per volume of ``calls`` calls ``run(vol, *fwd_args)`` (the first
    call has captured already: ``serving_masks``)."""
    _on_card(vol, fwd_args)
    with torch.inference_mode():
        return _event_ms(lambda: run(vol, *fwd_args), calls)[0]


def time_e2e(fwd, volume: np.ndarray, fwd_args, calls: int, context: int,
             batch_size: int):
    """``predict_volume`` of the host ``volume`` (upload, the one-graph
    volume, readback): (ms of the first call, which captures, [ms of each
    of ``calls`` later calls])."""
    _on_card(fwd_args)
    walls = _wall_ms(lambda: inference.predict_volume(
        fwd, volume, context=context, batch_size=batch_size,
        fwd_args=fwd_args, single_dispatch=True, device="cuda"), 1 + calls)
    return walls[0], walls[1:]


def matmul_tflops(a, links: int = MATMUL_LINKS) -> float:
    """TFLOP/s of a chain of ``links`` products ``x = a @ x`` (each needs
    the last) from the square ``a``, scaled to unit output variance so that
    the chain stays finite: median of 3 chains after a warm-up, CUDA
    events."""
    _on_card(a)

    def chain():
        x = a
        for _ in range(links):
            x = a @ x
        return x

    chain()
    ms, x = _event_ms(chain, 3)
    if not torch.isfinite(x).all():
        raise RuntimeError("the matmul chain did not stay finite")
    n = a.shape[0]
    return 2 * n ** 3 * links / (float(np.median(ms)) / 1e3) / 1e12


def hbm_gbps(x, links: int = HBM_LINKS) -> float:
    """GB/s of a chain of ``links`` in-place multiply-adds ``x += a * x``
    (one vectorised kernel each: one read and one write of ``x``): median
    of 3 chains after a warm-up, CUDA events."""
    _on_card(x)

    def chain():
        for _ in range(links):
            x.add_(x, alpha=-1e-7)

    chain()
    ms, _ = _event_ms(chain, 3)
    if not torch.isfinite(x).all():
        raise RuntimeError("the multiply-add chain did not stay finite")
    return 2 * x.numel() * x.element_size() * links \
        / (float(np.median(ms)) / 1e3) / 1e9


# ------------------------------------------------------------------ checks
def check_step1(label: str, head_step, kern_step, state, batch) -> float:
    """One step of each path from ``state`` and ``batch`` with one seed:
    the largest relative difference of their losses, which must be within
    ``STEP1_RTOL`` (both paths run the same warp on the same draw; only the
    f32 train forward's summation order differs).  Raises unless the
    kernel path alone launched the conv + BN-moments kernel."""
    before = train_conv.LAUNCHES
    _, mh = head_step(state, batch, 0)
    head = train_conv.LAUNCHES - before
    _, mk = kern_step(state, batch, 0)
    kern = train_conv.LAUNCHES - before - head
    if head or not kern:
        raise RuntimeError(f"{label} step 1: conv_stats launched {head} "
                           f"times on the headline, {kern} on the kernel "
                           "path")
    _finite(f"{label} step 1", {**mh, **mk})
    rel = max(abs(float(mk[k]) - float(mh[k])) / abs(float(mh[k]))
              for k in STEP1_LOSSES[label])
    if not rel <= STEP1_RTOL:
        raise RuntimeError(f"{label} step 1: kernel path {mk} against the "
                           f"headline {mh}: {rel:.3e} > {STEP1_RTOL}")
    return rel


def serving_masks(runs, vol, fwd_args) -> dict:
    """The first call of each ``(name, runner)`` of ``runs`` (a capture)
    and the label volumes it returns."""
    _on_card(vol, fwd_args)
    with torch.inference_mode():
        return {name: run(vol, *fwd_args) for name, run in runs}


def check_agreement(plain, fused, dtype: str) -> float:
    """The share of voxels whose fused label equals the plain one, at
    least ``AGREE[dtype]``."""
    share = float((plain == fused).float().mean())
    if not share >= AGREE[dtype]:
        raise RuntimeError(f"fused serving masks agree with apply's on "
                           f"{share:.5f} of voxels in {dtype}, under "
                           f"{AGREE[dtype]}")
    return share


# ------------------------------------------------------------------ result
def _quartiles(xs) -> list:
    return [float(v) for v in np.percentile(xs, [25, 50, 75])]


def result(m: dict) -> dict:
    """The printed line from the raw measurements ``m`` (``measure``'s):
    medians, rates, shares.  Raises if a share exceeds ``MAX_SHARE``."""
    med = {k: float(np.median(m[k])) for k in (
        "adapt_ms", "adapt_ms_eager", "adapt_ms_kernel", "source_ms",
        "source_ms_eager", "source_ms_kernel", "serve_ms", "serve_bf16_ms",
        "serve_fused_ms", "serve_fused_bf16_ms", "e2e_ms", "floor_ms")}
    b, s = m["batch"], m["slices"]
    peak, hbm = m["peak_tflops"], m["hbm_gbps"]
    a_tflops = m["adapt_flops"] / med["adapt_ms"] / 1e9
    s_tflops = m["source_flops"] / med["source_ms"] / 1e9
    extra = {
        "adapt_step_ms": med["adapt_ms"],
        "adapt_flops_per_step": m["adapt_flops"],
        "adapt_tflops_per_sec": a_tflops,
        "adapt_mfu_vs_measured_peak": a_tflops / peak,
        "adapt_hbm_bytes_xla_estimate": None,
        "adapt_hbm_bw_utilization_xla_estimate": None,
        "adapt_hbm_bytes_measured": None,
        "adapt_hbm_gbps_measured": None,
        "adapt_hbm_bw_utilization_measured": None,
        "source_train_slices_per_sec": b / med["source_ms"] * 1e3,
        "source_step_ms": med["source_ms"],
        "source_flops_per_step": m["source_flops"],
        "source_tflops_per_sec": s_tflops,
        "source_mfu_vs_measured_peak": s_tflops / peak,
        "source_hbm_bytes_xla_estimate": None,
        "source_hbm_bw_utilization_xla_estimate": None,
        "serving_slices_per_sec": s / med["serve_ms"] * 1e3,
        "serving_bf16_slices_per_sec": s / med["serve_bf16_ms"] * 1e3,
        "serving_volume_ms": med["serve_ms"],
        "serving_volume_ms_is_marginal": False,
        "serving_e2e_volume_ms": med["e2e_ms"],
        "serving_e2e_volume_ms_cold": m["e2e_cold_ms"],
        "measured_peak_tflops": peak,
        "measured_peak_tflops_f32": m["peak_tflops_f32"],
        "measured_hbm_gbps": hbm,
        "dispatch_floor_ms": med["floor_ms"] - med["adapt_ms"],
        # the port's own
        "adapt_step_ms_eager": med["adapt_ms_eager"],
        "source_step_ms_eager": med["source_ms_eager"],
        "adapt_step_ms_kernel_path": med["adapt_ms_kernel"],
        "adapt_train_slices_per_sec_kernel_path":
            b / med["adapt_ms_kernel"] * 1e3,
        "source_step_ms_kernel_path": med["source_ms_kernel"],
        "source_train_slices_per_sec_kernel_path":
            b / med["source_ms_kernel"] * 1e3,
        "serving_fused_slices_per_sec": s / med["serve_fused_ms"] * 1e3,
        "serving_fused_bf16_slices_per_sec":
            s / med["serve_fused_bf16_ms"] * 1e3,
        "adapt_device_busy_ms": m["adapt_profile"]["device_busy_ms_per_step"],
        "adapt_idle_share": m["adapt_profile"]["idle_share"],
        "source_device_busy_ms":
            m["source_profile"]["device_busy_ms_per_step"],
        "source_idle_share": m["source_profile"]["idle_share"],
        "step1_rel": m["step1_rel"],
        "serving_mask_agreement": m["agreement"],
        "launches": m["launches"],
        "timing": {
            "calls": m["calls"], "steps_per_call": m["steps"],
            "quartiles_ms": {"adapt_step_ms": _quartiles(m["adapt_ms"]),
                             "source_step_ms": _quartiles(m["source_ms"]),
                             "serving_volume_ms": _quartiles(m["serve_ms"])},
        },
        "card": m["card"], "settings": m["settings"],
        "torch": m["torch"], "cuda": m["cuda"],
    }
    missing = set(BENCH_PY_KEYS) - set(extra)
    if missing:
        raise KeyError(f"extra lacks bench.py's keys {sorted(missing)}")
    over = {k: v for k, v in extra.items()
            if ("_mfu_" in k or "_utilization_" in k) and v is not None
            and not v <= MAX_SHARE}
    if over:
        raise RuntimeError(f"shares over {MAX_SHARE}, a counting or timing "
                           f"fault: {over}")
    adapt_sps = b / med["adapt_ms"] * 1e3
    return {"metric": METRIC, "value": adapt_sps, "unit": UNIT,
            "vs_baseline": adapt_sps / reference_baseline(), "extra": extra}


# ----------------------------------------------------------------- measure
def _launches() -> dict:
    """The kernels' launch counters (each wrapper counts its own launches:
    eager, and those a capture records)."""
    return {"warp_affine": warp.LAUNCHES, "conv_stats": train_conv.LAUNCHES,
            "conv_bn_act": fused_conv.LAUNCHES}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def measure(calls: int, steps: int) -> dict:
    """Every raw measurement of one run on ``cuda``; the checks first."""
    dev = device_mod.resolve("cuda", deterministic=True)
    cfg = bench_config()
    kcfg = kernel_path(cfg)
    check_same_math(cfg, kcfg)
    b, size = cfg.data.batch_size, cfg.data.slice_size
    c, k = cfg.data.context_slices, cfg.data.num_classes
    m = {"batch": b, "calls": calls, "steps": steps, "slices": SLICES,
         "card": device_mod.card(), "settings": device_mod.settings(),
         "torch": torch.__version__, "cuda": torch.version.cuda}

    def dev_normal(seed, shape):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            shape).astype(np.float32)).to(dev)

    params, bn = segmenter.init(cfg.segmenter,
                                generator=prng.generator(0, dev), device=dev)
    a_state = adapt.init_state(1, cfg, params, bn)
    a_batch = {"src_image": dev_normal(2, (b, size, size, c)),
               "tgt_image": dev_normal(3, (b, size, size, c))}
    s_state = source.init_state(6, cfg, dev)
    labels = np.random.default_rng(7).integers(0, k, (b, size, size))
    s_batch = {"image": a_batch["src_image"],
               "label": torch.nn.functional.one_hot(
                   torch.from_numpy(labels).to(dev), k).float()}
    paths = {"adapt": (adapt.make_adapt_step, a_state, a_batch),
             "source": (source.make_train_step, s_state, s_batch)}

    # ---- checks, before any timing
    m["step1_rel"] = {name: check_step1(name, make(cfg), make(kcfg), st, bt)
                      for name, (make, st, bt) in paths.items()}
    volume = np.random.default_rng(8).standard_normal(
        (SLICES, size, size)).astype(np.float32)
    vol = torch.from_numpy(volume).to(dev)
    seg16 = dataclasses.replace(cfg.segmenter, compute_dtype="bfloat16")
    serving = [(f"{name}{tag}", inference._scanned_argmax(
        eval_forward(seg, fused), (tuple(vol.shape), dev, True), c, b))
        for tag, seg in (("", cfg.segmenter), ("_bf16", seg16))
        for name, fused in (("serve", False), ("serve_fused", True))]
    before = _launches()
    masks = serving_masks(serving, vol, (params, bn))  # the captures
    launched = _since(before)
    m["agreement"] = {
        "float32": check_agreement(masks["serve"], masks["serve_fused"],
                                   "float32"),
        "bfloat16": check_agreement(masks["serve_bf16"],
                                    masks["serve_fused_bf16"], "bfloat16")}

    # ---- FLOPs per step: one eager headline step, convs on cuDNN
    for name, (make, st, bt) in paths.items():
        m[f"{name}_flops"] = step_flops(make(cfg), st, bt)

    # ---- steps
    before = _launches()
    for name, (make, st, bt) in paths.items():
        for tag, c_, graph in (("", cfg, True), ("_kernel", kcfg, True),
                               ("_eager", cfg, False)):
            step = loop.scanned_step(make(c_), steps, graph=graph)
            m[f"{name}_ms{tag}"] = time_steps(step, st, bt, calls, steps)
            del step
        short = loop.scanned_step(make(cfg), PROFILE_STEPS, graph=True)
        m[f"{name}_profile"] = busy(short, st, bt, PROFILE_STEPS)
        del short
    one = loop.scanned_step(adapt.make_adapt_step(cfg), 1, graph=True)
    m["floor_ms"] = call_floor_ms(one, a_state, a_batch, FLOOR_CALLS)
    del one

    # ---- serving
    for name, run in serving:
        m[f"{name}_ms"] = time_volumes(run, vol, (params, bn), calls)
    m["e2e_cold_ms"], m["e2e_ms"] = time_e2e(
        eval_forward(cfg.segmenter, False), volume, (params, bn), calls, c, b)
    m["launches"] = {k: v + launched[k] for k, v in _since(before).items()}
    idle = [k for k, v in m["launches"].items() if not v]
    if idle:
        raise RuntimeError(f"the timed paths launched no {idle}")

    # ---- peaks
    for key, dtype in (("peak_tflops", torch.bfloat16),
                       ("peak_tflops_f32", torch.float32)):
        a = torch.randn((MATMUL_N, MATMUL_N), device=dev,
                        generator=prng.generator(9, dev)) * MATMUL_N ** -0.5
        m[key] = matmul_tflops(a.to(dtype))
    m["hbm_gbps"] = hbm_gbps(torch.ones(HBM_ELEMENTS, device=dev))
    return m


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mcmda_tpu_torch.bench",
        description="The port's benchmark on one CUDA device: one JSON line")
    p.add_argument("--calls", type=int, default=CALLS,
                   help="timed calls per figure, after one warm-up call")
    p.add_argument("--steps", type=int, default=STEPS,
                   help="train steps per graph call")
    args = p.parse_args(argv)
    if args.calls < 1 or args.steps < 1:
        p.error("--calls and --steps must be at least 1")
    if not torch.cuda.is_available():  # bench.py's line of a failed run
        print(json.dumps({
            "metric": METRIC, "value": 0.0, "unit": UNIT, "vs_baseline": 0.0,
            "extra": {"error": "no CUDA device: torch.cuda.is_available() "
                               "is false"}}), flush=True)
        return 2
    print(json.dumps(result(measure(args.calls, args.steps))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
