"""The port's bench (``mcmda_tpu_torch/bench.py``) on the CPU: its FLOP
count against XLA's, the keys it prints against ``bench.py``'s, and that
it never runs or times anything off the card.

The FLOP count follows XLA's ``HloCostAnalysis`` convention, which gave
``bench.py``'s figure: 2 per multiply-add of every convolution and matrix
product, a conv tap only where it falls inside the input (the padding's
taps are not counted), elementwise work not counted.  A single conv equals
XLA's ``cost_analysis()['flops']`` exactly; its backward counts the same
taps once per gradient asked for.

Whole steps, at the small config of ``_small`` (64 px, batch 2, widths
16-64, no augmentation, ``thin_layout`` nhwc), against XLA's count of the
JAX package's compiled step: measured here, the port's count is 5.78%
under XLA's for the source step and 5.22% under for the adapt step (with
widths 8-32 it was 10.3% and 8.5% under: the gap shrinks as the convs'
share grows).  Both gaps go one way, XLA's count the larger:
- XLA counts elementwise work (BN, activations, losses, Adam) as one FLOP
  per element and operation, which the port's convention leaves out;
- the x8 upsample is two dense products with per-axis weight matrices in
  both (``jax.image.resize`` lowers to ``dot_general``s of the same
  shapes), equal but for XLA's count of building the weights (744,192
  against 737,280 FLOPs for [2,8,8,5] -> [2,64,64,5]).
So the pair is held to port <= XLA and port >= (1 - STEP_GAP) XLA.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmda_tpu import config as jcfg
from mcmda_tpu.models import segmenter as jseg
from mcmda_tpu.train import adapt as jadapt
from mcmda_tpu.train import source as jsource
from mcmda_tpu_torch import bench
from mcmda_tpu_torch import config as tcfg
from mcmda_tpu_torch.ops import layers
from mcmda_tpu_torch.train import adapt, source

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_GAP = 0.07  # measured 5.22-5.78% (module docstring)

# XLA's cost_analysis()['flops'] of a SAME 3x3 conv on [1,32,32,64],
# 64 -> 64, by (dilation, stride); dense would be 75,497,472 at stride 1
XLA_CONV = {(1, 1): 72_384_512, (2, 1): 69_337_088, (4, 1): 63_438_848,
            (1, 2): 18_096_128}


def _xla_flops(fn, *args) -> float:
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    return float((ca[0] if isinstance(ca, list) else ca)["flops"])


def _conv_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 32, 32, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 64)) / 24).astype(np.float32)
    return x, w


def _jax_conv(dilation, stride):
    return lambda x, w: jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME", rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _port_conv(dilation, stride):
    return lambda p, x, seed: layers.conv_apply(p, x, stride=stride,
                                                dilation=dilation)


@pytest.mark.parametrize("dilation,stride", list(XLA_CONV))
def test_conv_count_equals_xla(dilation, stride):
    """One SAME conv: the port's count == XLA's, exactly (a stride-2 conv
    on even input pads (0, 1), which ``conv_apply`` pads explicitly)."""
    x, w = _conv_inputs()
    xla = _xla_flops(_jax_conv(dilation, stride), x, w)
    assert xla == XLA_CONV[dilation, stride]
    got = bench.step_flops(_port_conv(dilation, stride),
                           {"w": torch.from_numpy(w)}, torch.from_numpy(x))
    assert got == XLA_CONV[dilation, stride]


@pytest.mark.parametrize("dilation,stride", list(XLA_CONV))
@pytest.mark.parametrize("grads", ["both", "input", "weight"])
def test_conv_backward_count(dilation, stride, grads):
    """Forward and backward of one conv: the forward's taps once more per
    gradient that autograd computes (a frozen weight has none, nor does an
    image), and XLA's count of ``grad`` of sum(y^2) only the loss's
    elementwise work above the port's."""
    x, w = _conv_inputs()
    xt = torch.from_numpy(x).requires_grad_(grads in ("both", "input"))
    wt = torch.from_numpy(w).requires_grad_(grads in ("both", "weight"))

    def loss(p, xx, seed):
        torch.square(layers.conv_apply(p, xx, stride=stride,
                                       dilation=dilation)).sum().backward()

    got = bench.step_flops(loss, {"w": wt}, xt)
    n_grads = {"both": 2, "input": 1, "weight": 1}[grads]
    assert got == (1 + n_grads) * XLA_CONV[dilation, stride]
    if grads == "both":
        f = _jax_conv(dilation, stride)
        xla = _xla_flops(jax.grad(lambda a, b: jnp.sum(jnp.square(f(a, b))),
                                  argnums=(0, 1)), x, w)
        out = x.shape[1] // stride
        assert got <= xla <= got + 4 * out * out * w.shape[-1]


@pytest.mark.parametrize("n_in,k,stride,pad,dilation",
                         [(32, 3, 1, 1, 1), (32, 3, 2, 0, 1), (4, 4, 1, 1, 1),
                          (8, 4, 2, 1, 1), (32, 3, 1, 4, 4), (5, 3, 3, 2, 2),
                          (3, 5, 1, 7, 3)])
def test_valid_taps_is_the_brute_force_count(n_in, k, stride, pad,
                                             dilation):
    n_out = (n_in + pad + pad - dilation * (k - 1) - 1) // stride + 1
    n_out = max(n_out, 1)
    brute = sum(1 for o in range(n_out) for t in range(k)
                if 0 <= o * stride + t * dilation - pad < n_in)
    assert bench._valid_taps(n_in, n_out, k, stride, pad, dilation) == brute


def _small():
    """The JAX config of the whole-step comparison (see the docstring)."""
    s = jcfg.StageSpec
    stages = (s("stem", 16, 1, 1, 1), s("rm1", 32, 2, 1, 1),
              s("rm2", 32, 2, 1, 1), s("rm3", 64, 2, 1, 1),
              s("rm4", 64, 1, 2, 1), s("rm5", 64, 1, 4, 1))
    return jcfg.ExperimentConfig(
        segmenter=jcfg.SegmenterConfig(stages=stages, thin_layout="nhwc"),
        critic=jcfg.CriticConfig(taps=("rm4", "rm5"), compress_features=8,
                                 widths=(8, 16), strides=(2, 1)),
        data=jcfg.DataConfig(slice_size=64, batch_size=2),
        adapt=jcfg.AdaptConfig(plug_depth="rm3", src_feats_bf16=True))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _inputs(cfg):
    rng = np.random.default_rng(0)
    b, s = cfg.data.batch_size, cfg.data.slice_size
    img = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    tgt = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    lab = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (b, s, s))]
    return img, tgt, lab


@pytest.mark.parametrize("which", ["source", "adapt"])
def test_step_count_against_xla(which):
    """One step (no augmentation) of the port under the bench's count and
    XLA's count of the JAX package's compiled step, same weights."""
    cfg = _small()
    tc = tcfg.ExperimentConfig.from_json(cfg.to_json())
    img, tgt, lab = _inputs(cfg)
    params, bn = jseg.init(jax.random.key(0), cfg.segmenter)
    if which == "source":
        js = jsource.init_state(jax.random.key(0), cfg)
        xla = _xla_flops(jsource.make_train_step(cfg, augment=False), js,
                         {"image": img, "label": lab}, jax.random.key(1))
        state = source.init_state(0, tc, "cpu")
        state = dataclasses.replace(
            state, params=_t(js.params), bn_state=_t(js.bn_state),
            opt_state=source.make_tx(tc).init(_t(js.params)))
        got = bench.step_flops(
            source.make_train_step(tc, augment=False), state,
            {"image": torch.from_numpy(img), "label": torch.from_numpy(lab)})
    else:
        ja = jadapt.init_state(jax.random.key(1), cfg, params, bn)
        xla = _xla_flops(jadapt.make_adapt_step(cfg, augment=False), ja,
                         {"src_image": img, "tgt_image": tgt},
                         jax.random.key(1))
        state = adapt.init_state(1, tc, _t(params), _t(bn))
        got = bench.step_flops(
            adapt.make_adapt_step(tc, augment=False), state,
            {"src_image": torch.from_numpy(img),
             "tgt_image": torch.from_numpy(tgt)})
    assert (1 - STEP_GAP) * xla <= got <= xla, (got, xla, got / xla - 1)


# ------------------------------------------------------------------ keys
def _bench_py_extra_keys() -> set:
    """The string keys of the dict under "extra" in ``bench.py``'s source,
    read with ``ast`` (importing it would import jax's TPU set-up)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        module = ast.parse(f.read())
    found = []
    for node in ast.walk(module):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "extra" \
                        and isinstance(v, ast.Dict):
                    found.append({kk.value for kk in v.keys
                                  if isinstance(kk, ast.Constant)})
    # the success line's extra; the error line's holds "error" only
    keys = [f for f in found if f != {"error"}]
    assert len(keys) == 1, found
    return keys[0]


def test_declared_keys_are_bench_py_keys():
    assert set(bench.BENCH_PY_KEYS) == _bench_py_extra_keys()
    assert len(bench.BENCH_PY_KEYS) == len(set(bench.BENCH_PY_KEYS))


def _measured(**over):
    """Raw measurements as ``bench.measure`` returns them, made up."""
    m = {"batch": 8, "calls": 5, "steps": 50, "slices": 64,
         "card": "NVIDIA H100 80GB HBM3, 700.00 W",
         "settings": {"tf32": False, "cudnn_deterministic": True},
         "torch": "2", "cuda": "12",
         "adapt_ms": [55.0, 55.2, 55.1, 55.4, 55.3],
         "adapt_ms_eager": [88.0] * 5, "adapt_ms_kernel": [50.0] * 5,
         "source_ms": [64.0] * 5, "source_ms_eager": [76.0] * 5,
         "source_ms_kernel": [58.0] * 5, "serve_ms": [75.0] * 5,
         "serve_bf16_ms": [73.0] * 5, "serve_fused_ms": [60.0] * 5,
         "serve_fused_bf16_ms": [58.0] * 5, "e2e_ms": [90.0] * 5,
         "e2e_cold_ms": 900.0, "floor_ms": [55.3] * 20,
         "adapt_flops": 1.0e12, "source_flops": 1.2e12,
         "peak_tflops": 700.0, "peak_tflops_f32": 50.0, "hbm_gbps": 3000.0,
         "adapt_profile": {"device_busy_ms_per_step": 53.0,
                           "idle_share": 0.04},
         "source_profile": {"device_busy_ms_per_step": 62.0,
                            "idle_share": 0.03},
         "step1_rel": {"adapt": 1e-6, "source": 1e-6},
         "agreement": {"float32": 1.0, "bfloat16": 0.999},
         "launches": {"warp_affine": 10, "conv_stats": 30,
                      "conv_bn_act": 76}}
    m.update(over)
    return m


def test_result_holds_every_bench_py_key():
    line = bench.result(_measured())
    assert line["metric"] == "adapt_train_slices_per_sec_per_chip"
    assert set(bench.BENCH_PY_KEYS) <= set(line["extra"])
    extra = line["extra"]
    assert line["value"] == pytest.approx(8 / 55.2e-3)
    assert extra["adapt_mfu_vs_measured_peak"] == pytest.approx(
        1e12 / 55.2e-3 / 700e12)
    assert extra["serving_slices_per_sec"] == pytest.approx(64 / 75e-3)
    assert extra["dispatch_floor_ms"] == pytest.approx(0.1)
    assert extra["serving_volume_ms_is_marginal"] is False
    assert extra["timing"]["quartiles_ms"]["adapt_step_ms"][1] == 55.2
    assert extra["adapt_hbm_bytes_measured"] is None
    json.dumps(line, allow_nan=False)


def test_result_raises_on_a_share_over_one():
    with pytest.raises(RuntimeError, match="shares over"):
        bench.result(_measured(adapt_flops=1e20))


def test_kernel_path_differs_in_train_fused_alone():
    cfg = bench.bench_config()
    assert cfg.data.warp == "pallas" and cfg.adapt.src_feats_bf16
    assert cfg.data.batch_size == 8 and cfg.data.slice_size == 256
    bench.check_same_math(cfg, bench.kernel_path(cfg))
    other = dataclasses.replace(bench.kernel_path(cfg), data=dataclasses.
                                replace(cfg.data, warp="xla"))
    with pytest.raises(ValueError):
        bench.check_same_math(cfg, other)


# ------------------------------------------------------------ off the card
def test_without_cuda_prints_the_error_line_and_exits_2():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "mcmda_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "adapt_train_slices_per_sec_per_chip"
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert "CUDA" in line["extra"]["error"]


def _cpu_cases():
    x = torch.zeros(2)
    state = {"w": torch.zeros(3)}
    step = lambda s, b, seed: (s, {})  # noqa: E731
    return {
        "time_steps": lambda: bench.time_steps(step, state, {"x": x}, 1, 1),
        "call_floor_ms": lambda: bench.call_floor_ms(step, state, {"x": x},
                                                     1),
        "busy": lambda: bench.busy(step, state, {"x": x}, 1),
        "time_volumes": lambda: bench.time_volumes(lambda v: v, x, (), 1),
        "time_e2e": lambda: bench.time_e2e(lambda v, p: v, np.zeros(
            (1, 4, 4), np.float32), (state,), 1, 1, 1),
        "matmul_tflops": lambda: bench.matmul_tflops(torch.eye(4)),
        "hbm_gbps": lambda: bench.hbm_gbps(torch.ones(4)),
        "serving_masks": lambda: bench.serving_masks([], x, ()),
    }


@pytest.mark.parametrize("helper", list(_cpu_cases()))
def test_timing_helpers_raise_on_a_cpu_tensor(helper):
    with pytest.raises(ValueError, match="CUDA device"):
        _cpu_cases()[helper]()


# ------------------------------------------------------------- bench_runs
def test_bench_runs_table_of_an_artifact():
    from mcmda_tpu_torch.scripts import bench_runs

    lines = [bench.result(_measured()),
             bench.result(_measured(adapt_ms=[60.0] * 5))]
    text = bench_runs.table({"command": "python -m mcmda_tpu_torch.bench",
                             "card": "NVIDIA H100 80GB HBM3, 700.00 W",
                             "runs": lines})
    assert "700.00 W" in text and "2 runs" in text
    row = [r for r in text.splitlines() if r.startswith("| `adapt_step_ms`")]
    assert row == ["| `adapt_step_ms` | 57.6 | 55.2 | 60.0 |"]
    assert "`launches.conv_stats`" in text
    assert "serving_volume_ms_is_marginal" not in text


def test_bench_runs_fails_with_the_bench(monkeypatch, tmp_path):
    from mcmda_tpu_torch.scripts import bench_runs

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.chdir(ROOT)
    with pytest.raises(RuntimeError, match="exited 2"):
        bench_runs.main(["--out", str(tmp_path / "a.json")])
    assert not (tmp_path / "a.json").exists()
