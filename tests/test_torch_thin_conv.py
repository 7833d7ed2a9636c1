"""The thin-stem conv (``kernels/thin_conv.py``) in the port against the JAX
package, on the CPU: the plain version against the Pallas kernel in
interpret mode, the custom VJP (dw by contraction, dx only on request), and
the channels-first stem with its BN state.

Tolerances: the conv atol 2e-4 against the interpret-mode kernel (the
tolerance of ``tests/test_thin_conv.py``), 2e-5 elsewhere in f32; gradients
within 1e-4 of the largest |gradient|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcmda_tpu.kernels import thin_conv as jtc
from mcmda_tpu_torch.kernels import thin_conv as tc


def _inputs(seed, n=2, size=32, c=3, k=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, size, size, c)).astype(np.float32)
    w = (0.2 * rng.normal(size=(3, 3, c, k))).astype(np.float32)
    return x, w


def test_plain_stem_conv_matches_pallas_interpret():
    x, w = _inputs(0)
    with pltpu.force_tpu_interpret_mode():
        want = jtc.stem_conv_nhwc(jnp.asarray(x), jnp.asarray(w))
    got = tc.stem_conv_nhwc(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (2, 16, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # the pre-padded channels-first form is the same function
    cf = tc.stem_conv_cf_reference(tc._pad_cf(torch.from_numpy(x)),
                                   tc._w27(torch.from_numpy(w)))
    np.testing.assert_allclose(cf.numpy(), got.numpy(), atol=1e-6)


def test_dw_matches_jax_contraction():
    x, w = _inputs(1, k=8)
    g = np.random.default_rng(2).normal(size=(2, 8, 32, 32)).astype(
        np.float32)
    dw27 = jtc.stem_conv_dw_cf(jtc._pad_cf(jnp.asarray(x)), jnp.asarray(g))
    want = np.asarray(jnp.transpose(dw27.reshape(3, 3, 3, 8), (1, 2, 0, 3)))
    got = tc.stem_conv_dw(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("input_grad", [False, True])
def test_vjp_matches_jax(input_grad):
    """dw always; dx None by default (JAX: zeros), the transposed conv with
    ``input_grad``."""
    x, w = _inputs(3)

    def jloss(xv, wv):
        return jnp.sum(jtc.stem_conv_nhwc(xv, wv, input_grad) ** 2)

    with pltpu.force_tpu_interpret_mode():
        jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = tc.stem_conv_nhwc(xt, wt, input_grad)
    dx, dw = torch.autograd.grad((y ** 2).sum(), (xt, wt),
                                 allow_unused=True)
    scale = np.abs(np.asarray(jdw)).max()
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw),
                               atol=1e-4 * scale)
    if input_grad:
        np.testing.assert_allclose(
            dx.numpy(), np.asarray(jdx),
            atol=1e-4 * np.abs(np.asarray(jdx)).max())
    else:
        assert dx is None
        assert not np.asarray(jdx).any()


def test_bf16_input_gets_bf16_dx():
    x, w = _inputs(4)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    y = tc.stem_conv_nhwc(xt, torch.from_numpy(w), True)
    assert y.dtype == torch.float32
    (dx,) = torch.autograd.grad(y.sum(), xt)
    assert dx.dtype == torch.bfloat16


@pytest.mark.parametrize("train", [True, False])
def test_stem_apply_cf_matches_jax(train):
    """The channels-first stem with BN state, train and eval mode, and the
    weight gradient through it."""
    x, w = _inputs(5)
    rng = np.random.default_rng(6)
    p = {"conv": {"w": w},
         "bn": {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
                "bias": (0.1 * rng.normal(size=16)).astype(np.float32)}}
    st = {"bn": {"mean": (0.1 * rng.normal(size=16)).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}}
    r = rng.normal(size=(2, 32, 32, 16)).astype(np.float32)

    def jloss(wv):
        jp = {"conv": {"w": wv}, "bn": jax.tree.map(jnp.asarray, p["bn"])}
        h, s = jtc.stem_apply_cf(jp, jax.tree.map(jnp.asarray, st),
                                 jnp.asarray(x), train=train, momentum=0.9,
                                 eps=1e-3)
        return jnp.sum(h * r), (h, s)

    with pltpu.force_tpu_interpret_mode():
        (_, (jh, js)), jdw = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    tp = {"conv": {"w": wt},
          "bn": {k: torch.from_numpy(v) for k, v in p["bn"].items()}}
    tst = {"bn": {k: torch.from_numpy(v) for k, v in st["bn"].items()}}
    h, s = tc.stem_apply_cf(tp, tst, torch.from_numpy(x), train=train,
                            momentum=0.9, eps=1e-3)
    (dw,) = torch.autograd.grad((h * torch.from_numpy(r)).sum(), wt)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               atol=2e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(s["bn"][k].numpy(),
                                   np.asarray(js["bn"][k]), atol=2e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw),
                               atol=1e-4 * np.abs(np.asarray(jdw)).max())


def test_cpu_runs_plain_version_and_counts_nothing():
    x, w = _inputs(7)
    before = tc.LAUNCHES
    y = tc.stem_conv_forward(torch.from_numpy(x), torch.from_numpy(w))
    assert tc.LAUNCHES == before
    torch.testing.assert_close(
        y, tc.stem_conv_nhwc_reference(torch.from_numpy(x),
                                       torch.from_numpy(w)))
    with pytest.raises(ValueError, match="no kernel for device"):
        tc.stem_conv_forward(torch.zeros(1, 4, 4, 3, device="meta"),
                             torch.zeros(3, 3, 3, 16, device="meta"))
