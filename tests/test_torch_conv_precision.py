"""The number format of the port's conv kernels, modelled in numpy on the CPU.

``csrc/conv_tile.cuh`` computes every f32 product of the implicit GEMM in
split TF32 on the tensor cores: each operand v is split into
``hi = tf32(v)`` (round to nearest, ties away, as ``cvt.rna``) and
``lo = v - hi`` truncated to TF32, and the three TF32 products
``lo_a*hi_b + hi_a*lo_b + hi_a*hi_b`` of every 32-deep reduction step are
summed, then added to an f32 accumulator, one step at a time.  This file
holds that arithmetic, before any card runs it:

(a) at the serving and training path's reduction lengths 9*C, its error
    against f64 is at most 4x the f32 error and below 1e-4, while
    single-pass TF32 exceeds 1e-4 at C = 512 (why the split is needed);
(b) a small conv through the modelled im2col GEMM, in the kernel's
    tap-major reduction order, agrees within 1e-4 with the JAX package's
    ``conv_bn_act_reference`` and with the port's plain version;
(c) bf16-valued inputs split with ``lo == 0`` exactly, so a bf16 x needs
    two products.

The kernel itself is checked on the card (``test_torch_kernel_gpu.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmda_tpu.kernels import fused_conv as jfk
from mcmda_tpu_torch.kernels import fused_conv as fk

BK = 32  # the kernel's reduction step (one tap x 32 channels)
TOL = 1e-4


def tf32_rna(v):
    """``cvt.rna.tf32.f32``: round the f32 significand to 10 bits, ties
    away from zero (on the bits: add half of the dropped 13, then clear
    them)."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_trunc(v):
    """Truncate the f32 significand to 10 bits (clear the low 13)."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(v):
    v = np.asarray(v, np.float32)
    hi = tf32_rna(v)
    return hi, tf32_trunc(v - hi)


def split_gemm(a, b, steps=None, skip_lo_a=False):
    """The kernel's arithmetic: [M, R] x [R, K] with three (two when
    ``skip_lo_a``) TF32 products, lo_a*hi_b, hi_a*lo_b, hi_a*hi_b, summed
    over each step (here in f64: the tensor core's own sum is only
    truncated within the step) and added to the f32 sum step by step."""
    ah, al = split(a)
    bh, bl = split(b)
    if steps is None:
        steps = [slice(s, s + BK) for s in range(0, a.shape[1], BK)]
    pairs = ([] if skip_lo_a else [(al, bh)]) + [(ah, bl), (ah, bh)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for sl in steps:
        part = sum(x[:, sl].astype(np.float64) @ y[sl].astype(np.float64)
                   for x, y in pairs)
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def _operands(reduction, seed=0, m=256, k=64):
    """Unit-normal inputs and He-scaled weights, as the path feeds them."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, reduction)).astype(np.float32)
    b = (rng.standard_normal((reduction, k))
         * np.sqrt(2.0 / reduction)).astype(np.float32)
    return a, b, a.astype(np.float64) @ b.astype(np.float64)


@pytest.mark.parametrize("c", [32, 64, 128, 256, 512])
def test_split_tf32_error_is_f32_class(c):
    a, b, exact = _operands(9 * c, seed=c)
    err = np.abs(split_gemm(a, b) - exact).max()
    f32_err = np.abs((a @ b).astype(np.float64) - exact).max()
    assert err <= 4 * f32_err, (err, f32_err)
    assert err < TOL


def test_single_pass_tf32_fails_the_tolerance():
    a, b, exact = _operands(9 * 512, seed=512)
    single = tf32_rna(a).astype(np.float64) @ tf32_rna(b).astype(np.float64)
    assert np.abs(single - exact).max() > TOL


def im2col(x, dilation):
    """[N,H,W,C] -> [N*H*W, 9*C] with zero (XLA SAME) padding, columns in
    the kernel's reduction order: tap (ky*3 + kx) major, channel minor,
    i.e. the rows of the HWIO weights reshaped to [9*C, K]."""
    n, h, w, c = x.shape
    d = dilation
    xp = np.pad(x, ((0, 0), (d, d), (d, d), (0, 0)))
    cols = [xp[:, ky * d:ky * d + h, kx * d:kx * d + w, :]
            for ky in range(3) for kx in range(3)]
    return np.concatenate(cols, -1).reshape(n * h * w, 9 * c)


def modelled_conv(x, w, scale, bias, residual, dilation, activation,
                  bf16_x=False):
    """The fused kernel's arithmetic: split-TF32 im2col GEMM in steps of
    one tap x 32 channels, then the epilogue in f32."""
    n, h, wd, c = x.shape
    k = w.shape[-1]
    steps = [slice(tap * c + c0, tap * c + min(c0 + BK, c))
             for tap in range(9) for c0 in range(0, c, BK)]
    z = split_gemm(im2col(x, dilation), w.reshape(9 * c, k), steps,
                   skip_lo_a=bf16_x)
    y = (z * scale + bias).astype(np.float32)
    if residual is not None:
        y = (y + residual.reshape(-1, k)).astype(np.float32)
    if activation == "relu":
        y = np.maximum(y, 0)
    elif activation == "leaky_relu":
        y = np.where(y >= 0, y, np.float32(0.2) * y)
    return y.reshape(n, h, wd, k)


def _bf16_valued(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("bf16_x", [False, True])
@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_modelled_conv_matches_references(dilation, bf16_x):
    # 5 x 7 planes: the dilation-4 taps fall off every edge
    rng = np.random.default_rng(dilation)
    x = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)
    if bf16_x:
        x = _bf16_valued(x)
    w = (rng.standard_normal((3, 3, 16, 8))
         * np.sqrt(2.0 / 144)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    res = rng.standard_normal((2, 5, 7, 8)).astype(np.float32)
    act = ("relu", "leaky_relu", "none")[dilation % 3]
    got = modelled_conv(x, w, scale, bias, res, dilation, act, bf16_x)
    want_jax = np.asarray(jfk.conv_bn_act_reference(
        *(jnp.asarray(a) for a in (x, w, scale, bias)), dilation=dilation,
        activation=act, residual=jnp.asarray(res)))
    want_torch = fk.conv_bn_act_reference(
        *(torch.from_numpy(a) for a in (x, w, scale, bias)),
        dilation=dilation, activation=act,
        residual=torch.from_numpy(res)).numpy()
    np.testing.assert_allclose(got, want_jax, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_torch, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_values_split_exactly(seed):
    v = _bf16_valued(np.random.default_rng(seed).standard_normal(
        4096).astype(np.float32) * 10.0 ** seed)
    hi, lo = split(v)
    assert np.array_equal(hi, v)
    assert not lo.any()


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_split_represents_f32_to_2_pow_minus_21(scale):
    v = (np.random.default_rng(7).standard_normal(4096) * scale).astype(
        np.float32)
    hi, lo = split(v)
    # both halves are TF32: the low 13 bits are clear
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    resid = np.abs(v.astype(np.float64) - hi - lo)
    assert (resid <= 2.0 ** -21 * np.abs(v)).all()
    # round to nearest: hi is within half a TF32 ulp (2^-11 relative)
    assert (np.abs(v.astype(np.float64) - hi) <= 2.0 ** -11 * np.abs(v)).all()
