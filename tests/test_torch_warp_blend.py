"""The arithmetic of the port's warp and thin-stem kernels, modelled in numpy
on the CPU (no card runs here; ``test_torch_kernel_gpu.py`` and
``chip_smoke.py`` hold the kernels themselves to the same statements).

``csrc/warp.cu`` rounds every product and sum to f32, in the plain
version's order: the coordinates ``(c0*y + c1*x) + c2``, the corner weights
``(1-wy)*(1-wx)`` .., the blend ``((w00*g00 + w01*g01) + w10*g10) +
w11*g11``, no FMA anywhere.  ``warp_model`` is that arithmetic, with the
label sum in the order of each of its kernels.  It is held

(a) bitwise to the port's ``warp_affine_reference`` on the image channels
    (what the card checks with ``torch.equal``), 1e-5 on the renormalised
    labels, whose sum PyTorch may order differently;
(b) at 1e-5, the tolerance of ``tests/test_torch_warp.py``, to the JAX
    oracle ``mcmda_tpu.kernels.warp.warp_affine_reference`` on the same
    numpy inputs.

``csrc/thin_conv.cu`` gives a thread four adjacent pixels along W and sums
the 27 products of each output in the order (dy, dx, c), each an FMA, with
SAME padding as zeros and the ragged last thread of a row storing only its
valid pixels.  ``stem_model`` is that loop, held at 1e-5 to the port's
``stem_conv_nhwc_reference`` and, at the tolerance of
``tests/test_torch_thin_conv.py``, to the JAX ``stem_conv_nhwc`` (its Pallas
kernel in interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcmda_tpu.kernels import thin_conv as jtc
from mcmda_tpu.kernels import warp as jwarp
from mcmda_tpu_torch.kernels import thin_conv as tc
from mcmda_tpu_torch.kernels import warp

F = np.float32
ATOL = 1e-5


def _fma(a, b, acc):
    """fmaf on f32 arrays: the product is exact in f64."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + acc.astype(np.float64)).astype(F)


def warp_model(img, coefs, n_image, label_order="sequential",
               contract=False):
    """The kernels' arithmetic on f32 numpy arrays (every numpy operation
    rounds its result to f32).  ``label_order``: "sequential" adds the label
    channels in channel order (the one-lane, staged and generic kernels);
    "quads" adds each float4 quad's labels in order, then the quads' sums
    (two lanes a pixel, completed by a shuffle).  ``contract`` fuses the
    blend's products into its sums, which the kernel must not do."""
    b, h, w, c = img.shape
    cf = coefs.astype(F)[:, :, None, None]
    y = np.arange(h, dtype=F)[None, :, None]
    x = np.arange(w, dtype=F)[None, None, :]
    ys = (cf[:, 0] * y + cf[:, 1] * x) + cf[:, 2]
    xs = (cf[:, 3] * y + cf[:, 4] * x) + cf[:, 5]
    valid = (ys >= 0) & (ys <= F(h - 1)) & (xs >= 0) & (xs <= F(w - 1))
    y0, x0 = np.floor(ys), np.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    my, mx = F(1) - wy, F(1) - wx
    y0c = np.clip(y0, 0, h - 1).astype(np.int64)
    x0c = np.clip(x0, 0, w - 1).astype(np.int64)
    y1c = np.minimum(y0c + 1, h - 1)
    x1c = np.minimum(x0c + 1, w - 1)
    bi = np.arange(b)[:, None, None]
    g00, g01 = img[bi, y0c, x0c], img[bi, y0c, x1c]
    g10, g11 = img[bi, y1c, x0c], img[bi, y1c, x1c]
    if contract:
        v = _fma(wy * wx, g11, _fma(wy * mx, g10, _fma(
            my * wx, g01, (my * mx) * g00)))
    else:
        v = ((((my * mx) * g00 + (my * wx) * g01) + (wy * mx) * g10)
             + (wy * wx) * g11)
    assert v.dtype == F
    v = np.where(valid[..., None], v, F(0))
    if n_image < c:
        if label_order == "sequential":
            total = np.zeros(v.shape[:3], F)
            for ch in range(n_image, c):
                total = total + v[..., ch]
        else:
            parts = []
            for q in range(0, c, 4):
                part = np.zeros(v.shape[:3], F)
                for ch in range(max(q, n_image), q + 4):
                    part = part + v[..., ch]
                parts.append(part)
            total = parts[0]
            for part in parts[1:]:
                total = total + part
        denom = np.maximum(total, F(1e-6))[..., None]
        v = np.concatenate([v[..., :n_image], v[..., n_image:] / denom], -1)
    return v


def _case(seed, c, n_image, shift, b=6, h=24, w=28):
    """Seeded draws over the shipped ranges (15 deg, zoom 0.9-1.1), flips
    alternating, the last image the identity; one-hot label channels."""
    rng = np.random.default_rng(seed)
    d = np.stack([np.arange(b) % 2,
                  rng.uniform(-1, 1, b) * np.deg2rad(15.0),
                  rng.uniform(0.9, 1.1, b),
                  rng.uniform(-shift, shift, b),
                  rng.uniform(-shift, shift, b)], -1).astype(F)
    d[-1] = [0, 0, 1, 0, 0]
    img = rng.normal(size=(b, h, w, n_image)).astype(F)
    if c > n_image:
        lab = np.eye(c - n_image, dtype=F)[
            rng.integers(0, c - n_image, (b, h, w))]
        img = np.concatenate([img, lab], -1)
    t = torch.from_numpy(d)
    coefs = warp.affine_coefs(t[:, 1], t[:, 2], t[:, 3], t[:, 4], t[:, 0],
                              h, w)
    return img, coefs.numpy()


CASES = [(8, 3, 8.0, "quads"), (8, 3, 8.0, "sequential"),
         (8, 3, 25.0, "quads"), (3, 3, 8.0, "sequential"),
         (3, 3, 25.0, "sequential"), (5, 2, 8.0, "sequential")]


@pytest.mark.parametrize("c,n_image,shift,order", CASES)
def test_warp_model_is_bitwise_the_plain_version(c, n_image, shift, order):
    """Flips, the identity row and (shift 25 of 24 rows) whole bands outside
    the image: image channels bit for bit, labels within 1e-5."""
    img, coefs = _case(c, c, n_image, shift)
    got = warp_model(img, coefs, n_image, order)
    want = warp.warp_affine_reference(torch.from_numpy(img),
                                      torch.from_numpy(coefs),
                                      n_image).numpy()
    np.testing.assert_array_equal(got[..., :n_image], want[..., :n_image])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[-1, ..., :n_image],
                                  img[-1, ..., :n_image])  # identity
    zero = np.all(want == 0, axis=-1)
    if shift > 20:
        assert zero.mean() > 0.1
    assert np.all(got[zero] == 0)
    s = got[..., n_image:].sum(-1)
    assert np.all((np.abs(s - 1) < 1e-5) | (s == 0))


@pytest.mark.parametrize("c,n_image,shift,order", CASES)
def test_warp_model_matches_jax_oracle(c, n_image, shift, order):
    img, coefs = _case(10 + c, c, n_image, shift)
    got = warp_model(img, coefs, n_image, order)
    both = np.asarray(jwarp.warp_affine_reference(jnp.asarray(img),
                                                  jnp.asarray(coefs)))
    lab = both[..., n_image:]
    lab = lab / np.maximum(lab.sum(-1, keepdims=True), 1e-6)
    np.testing.assert_allclose(got[..., :n_image], both[..., :n_image],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[..., n_image:], lab, rtol=0, atol=ATOL)


def test_contracted_blend_is_not_bitwise():
    """Why the kernel spells out its roundings: with the products fused into
    the sums (what a compiler makes of ``a*b + c*d + ..``) some image values
    differ from the plain version in their last bits, though by less than
    1e-5."""
    img, coefs = _case(3, 3, 3, 8.0)
    want = warp_model(img, coefs, 3)
    fused = warp_model(img, coefs, 3, contract=True)
    assert np.any(fused != want)
    np.testing.assert_allclose(fused, want, rtol=0, atol=ATOL)


def stem_model(x, w):
    """The stem kernel's loop: thread t of a row makes pixels 4t .. 4t+3,
    reads its 3 x 6 x C neighbourhood with zeros outside the image, and adds
    each output's products in the order (dy, dx, c), each an FMA; pixels at
    or beyond W are computed and not stored."""
    n, h, wd, c = x.shape
    k = w.shape[-1]
    threads = -(-wd // 4)
    xp = np.zeros((n, h + 2, 4 * threads + 2, c), F)
    xp[:, 1:h + 1, 1:wd + 1] = x
    acc = np.zeros((n, h, threads, 4, k), F)
    col = 4 * np.arange(threads)[:, None] + np.arange(4)[None, :]
    for dy in range(3):
        for dx in range(3):
            for ci in range(c):
                xv = xp[:, dy:dy + h][:, :, col + dx, ci]
                acc = _fma(xv[..., None], w[dy, dx, ci], acc)
    y = acc.reshape(n, h, 4 * threads, k)[:, :, :wd]
    return np.ascontiguousarray(y.transpose(0, 3, 1, 2))


def _stem_inputs(seed, n, h, wd, c, k):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h, wd, c)).astype(F),
            (0.2 * rng.normal(size=(3, 3, c, k))).astype(F))


@pytest.mark.parametrize("n,h,wd,c,k", [
    (2, 16, 32, 3, 16), (2, 9, 41, 3, 16), (1, 7, 6, 3, 8), (1, 5, 3, 3, 32),
    (1, 6, 13, 1, 16), (1, 4, 10, 16, 8)])
def test_stem_model_matches_plain(n, h, wd, c, k):
    """Whole and ragged last threads (W % 4 != 0, W < 4), every border,
    each K, the thinnest and the widest C."""
    x, w = _stem_inputs(0, n, h, wd, c, k)
    want = tc.stem_conv_nhwc_reference(torch.from_numpy(x),
                                       torch.from_numpy(w)).numpy()
    got = stem_model(x, w)
    assert got.shape == want.shape == (n, k, h, wd)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("size", [32, 16])
def test_stem_model_matches_pallas_interpret(size):
    x, w = _stem_inputs(1, 2, size, size, 3, 16)
    with pltpu.force_tpu_interpret_mode():
        want = jtc.stem_conv_nhwc(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(stem_model(x, w), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
