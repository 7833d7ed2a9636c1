"""The port's fused conv+BN+activation op and its layers against the JAX
package, on the CPU.

Same numpy-seeded inputs go through both.  On the CPU the port's wrapper
runs its plain PyTorch version; the JAX side runs its XLA reference and, as
``tests/test_kernels.py`` does, the Pallas kernel in TPU-interpret mode.
The CUDA kernel itself is checked on the card (``chip_smoke.py`` and
``test_torch_kernel_gpu.py``).

Tolerances: f32 atol 1e-4 (as ``test_kernels.py``): both sides sum the same
products in different orders.  bf16 inputs are held to the same tolerance,
because both sides widen bf16 to f32 exactly before an f32 conv.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcmda_tpu.kernels import fused_conv as jfk
from mcmda_tpu.ops import layers as jlayers
from mcmda_tpu_torch.kernels import build
from mcmda_tpu_torch.kernels import fused_conv as fk
from mcmda_tpu_torch.ops import layers

ATOL = 1e-4


def _inputs(seed, n=2, h=12, w=10, c=8, k=16, residual=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, c, k)) * np.sqrt(2.0 / (9 * c))) \
        .astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=k).astype(np.float32)
    bias = rng.normal(size=k).astype(np.float32)
    res = rng.normal(size=(n, h, w, k)).astype(np.float32) if residual \
        else None
    return x, wt, scale, bias, res


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_reference_matches_jax(dilation, activation, residual):
    x, w, s, b, r = _inputs(dilation, residual=residual)
    want = jfk.conv_bn_act_reference(_jax(x), _jax(w), _jax(s), _jax(b),
                                     dilation=dilation, activation=activation,
                                     residual=_jax(r))
    got = fk.conv_bn_act_reference(_torch(x), _torch(w), _torch(s), _torch(b),
                                   dilation=dilation, activation=activation,
                                   residual=_torch(r))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dilation,activation,residual", [
    (1, "relu", False), (1, "relu", True), (2, "leaky_relu", True),
    (4, "none", False), (4, "relu", True)])
def test_reference_matches_pallas_interpret(dilation, activation, residual):
    x, w, s, b, r = _inputs(10 + dilation, residual=residual)
    with pltpu.force_tpu_interpret_mode():
        want = jfk.conv_bn_act_pallas(_jax(x), _jax(w), _jax(s), _jax(b),
                                      dilation=dilation,
                                      activation=activation,
                                      residual=_jax(r), k_tile=16)
    got = fk.conv_bn_act(_torch(x), _torch(w), _torch(s), _torch(b),
                         dilation=dilation, activation=activation,
                         residual=_torch(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("x_bf16,res_bf16", [(True, False), (False, True),
                                             (True, True)])
def test_bf16_inputs_match_jax_reference(x_bf16, res_bf16):
    """The serving flow under eval_bf16 hands the fused op bf16 x (conv1
    after a strided block) or a bf16 residual (conv2): the output is f32."""
    x, w, s, b, r = _inputs(7)
    xd = (torch.bfloat16, jnp.bfloat16) if x_bf16 else (torch.float32,
                                                       jnp.float32)
    rd = (torch.bfloat16, jnp.bfloat16) if res_bf16 else (torch.float32,
                                                         jnp.float32)
    want = jfk.conv_bn_act_reference(_jax(x, xd[1]), _jax(w), _jax(s),
                                     _jax(b), dilation=2,
                                     residual=_jax(r, rd[1]))
    got = fk.conv_bn_act(_torch(x, xd[0]), _torch(w), _torch(s), _torch(b),
                         dilation=2, residual=_torch(r, rd[0]))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(3)
    p = {"scale": rng.normal(size=6), "bias": rng.normal(size=6)}
    st = {"mean": rng.normal(size=6), "var": rng.uniform(0.1, 2, size=6)}
    p, st = ({k: v.astype(np.float32) for k, v in d.items()} for d in (p, st))
    want = jfk.fold_bn({k: jnp.asarray(v) for k, v in p.items()},
                       {k: jnp.asarray(v) for k, v in st.items()}, 1e-3)
    got = fk.fold_bn({k: torch.from_numpy(v) for k, v in p.items()},
                     {k: torch.from_numpy(v) for k, v in st.items()}, 1e-3)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-6)


@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("stride,dilation,kernel", [(2, 1, 3), (1, 2, 3),
                                                    (2, 1, 1)])
def test_conv_same_padding_matches_xla(size, stride, dilation, kernel):
    """XLA SAME pads low = total // 2: a stride-2 3x3 conv pads (0, 1) on
    even input and (1, 1) on odd input."""
    rng = np.random.default_rng(size + stride)
    x = rng.normal(size=(2, size, size + 1, 4)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 4, 5)).astype(np.float32)
    want = jlayers.conv_apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                              stride=stride, dilation=dilation)
    got = layers.conv_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                            stride=stride, dilation=dilation)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if stride == 2 and kernel == 3:
        assert layers.same_padding(size, 3, 2, 1) == \
            ((0, 1) if size % 2 == 0 else (1, 1))


def test_bilinear_upsample_matches_jax_resize():
    """Half-pixel centres with edge clamping, borders included."""
    x = np.random.default_rng(4).normal(size=(2, 4, 5, 3)).astype(np.float32)
    want = jlayers.bilinear_upsample(jnp.asarray(x), 8)
    got = layers.bilinear_upsample(torch.from_numpy(x), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bn_apply_matches_jax_eval():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 3, 4)).astype(np.float32)
    p = {"scale": rng.normal(size=4).astype(np.float32),
         "bias": rng.normal(size=4).astype(np.float32)}
    st = {"mean": rng.normal(size=4).astype(np.float32),
          "var": rng.uniform(0.5, 2, size=4).astype(np.float32)}
    want, _ = jlayers.bn_apply({k: jnp.asarray(v) for k, v in p.items()},
                               {k: jnp.asarray(v) for k, v in st.items()},
                               jnp.asarray(x), train=False)
    got = layers.bn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                          {k: torch.from_numpy(v) for k, v in st.items()},
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    x, w, s, b, r = (_torch(a) for a in _inputs(8))
    before = fk.LAUNCHES
    got = fk.conv_bn_act(x, w, s, b, dilation=2, residual=r)
    want = fk.conv_bn_act_reference(x, w, s, b, dilation=2, residual=r)
    assert torch.equal(got, want)
    assert fk.LAUNCHES == before


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.empty((1, 4, 4, 2), device="meta")
    w = torch.empty((3, 3, 2, 2), device="meta")
    s = torch.empty((2,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fk.conv_bn_act(x, w, s, s)


def test_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "_build").exists()
