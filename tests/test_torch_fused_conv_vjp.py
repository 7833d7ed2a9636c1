"""The port's differentiable fused conv (``fused_conv.ConvBnAct``) against
the JAX package's ``conv_bn_act`` custom VJP, on the CPU.

The same numpy-seeded x, w, scale, bias and cotangent go through both: the
JAX side runs its Pallas forward in TPU-interpret mode under ``jax.grad``,
as ``tests/test_kernels.py`` does; on the CPU the port's Function runs the
plain forward and its own backward.  The kernel's forward under the
Function is held on the card (``chip_smoke.py`` phase 3).

Tolerance: atol = rtol = 1e-3, the JAX package's own pair for its VJP
against ``jax.grad`` of its oracle; the gradients are sums of up to 288
products taken in different orders on the two sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcmda_tpu.kernels import fused_conv as jfk
from mcmda_tpu_torch.kernels import fused_conv as fk

TOL = 1e-3
NAMES = ("dx", "dw", "dscale", "dbias")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 4, 8)) * 0.1).astype(np.float32)
    scale = (np.abs(rng.normal(size=8)) + 0.5).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    ct = rng.normal(size=(1, 8, 8, 8)).astype(np.float32)
    return x, w, scale, bias, ct


def _jax_grads(arrays, dilation, activation):
    x, w, s, b, ct = (jnp.asarray(a) for a in arrays)

    def loss(x, w, s, b):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jfk.conv_bn_act(x, w, s, b, dilation, activation)
                           * ct)

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2, 3))(x, w, s, b)]


def _torch_grads(arrays, fn):
    x, w, s, b, ct = (torch.from_numpy(a).requires_grad_() for a in arrays)
    y = fn(x, w, s, b)
    assert y.grad_fn is not None
    return [g.numpy() for g in
            torch.autograd.grad((y * ct.detach()).sum(), (x, w, s, b))]


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("dilation", [1, 2])
def test_vjp_matches_jax_custom_vjp(dilation, activation):
    arrays = _inputs()
    want = _jax_grads(arrays, dilation, activation)
    got = _torch_grads(arrays, lambda x, w, s, b: fk.conv_bn_act_vjp(
        x, w, s, b, dilation, activation))
    for name, g, ref in zip(NAMES, got, want):
        assert g.shape == ref.shape, name
        np.testing.assert_allclose(g, ref, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
def test_wrapper_under_autograd_takes_the_function(activation):
    """``conv_bn_act`` on inputs that require grad is ``ConvBnAct``: the
    same gradients, and the plain version's autograd agrees with both."""
    arrays = _inputs(1)
    via_fn = _torch_grads(arrays, lambda x, w, s, b: fk.conv_bn_act_vjp(
        x, w, s, b, 2, activation))
    via_wrapper = _torch_grads(arrays, lambda x, w, s, b: fk.conv_bn_act(
        x, w, s, b, dilation=2, activation=activation))
    plain = _torch_grads(arrays, lambda x, w, s, b: fk.conv_bn_act_reference(
        x, w, s, b, dilation=2, activation=activation))
    x, w, s, b, _ = (torch.from_numpy(a).requires_grad_() for a in arrays)
    assert type(fk.conv_bn_act(x, w, s, b, dilation=2,
                               activation=activation).grad_fn).__name__ \
        == "ConvBnActBackward"
    for name, a, c, p in zip(NAMES, via_wrapper, via_fn, plain):
        np.testing.assert_array_equal(a, c, err_msg=name)
        np.testing.assert_allclose(a, p, atol=TOL, rtol=TOL, err_msg=name)


def test_wrapper_without_grad_takes_the_plain_dispatch():
    """Under no_grad / inference_mode, or with no input requiring grad, the
    wrapper returns the plain version's tensor and records nothing."""
    x, w, s, b, _ = (torch.from_numpy(a) for a in _inputs(2))
    want = fk.conv_bn_act_reference(x, w, s, b, dilation=2)
    assert torch.equal(fk.conv_bn_act(x, w, s, b, dilation=2), want)
    wg = w.clone().requires_grad_()
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            y = fk.conv_bn_act(x, wg, s, b, dilation=2)
        assert y.grad_fn is None and torch.equal(y, want)


@pytest.mark.parametrize("needs_grad", ["x", "w", "scale", "bias",
                                        "residual"])
def test_residual_with_grad_raises(needs_grad):
    x, w, s, b, r = (torch.from_numpy(a) for a in _inputs(3))
    args = dict(x=x, w=w, scale=s, bias=b, residual=r)
    args[needs_grad] = args[needs_grad].clone().requires_grad_()
    with pytest.raises(ValueError, match="no residual"):
        fk.conv_bn_act(args["x"], args["w"], args["scale"], args["bias"],
                       residual=args["residual"])
    with torch.no_grad():  # the serving form keeps its residual
        fk.conv_bn_act(args["x"], args["w"], args["scale"], args["bias"],
                       residual=args["residual"])


def test_bf16_x_gets_a_bf16_dx():
    x, w, s, b, ct = (torch.from_numpy(a) for a in _inputs(4))
    xb = x.to(torch.bfloat16).requires_grad_()
    y = fk.conv_bn_act_vjp(xb, w, s, b, 1, "relu")
    (dx,) = torch.autograd.grad((y * ct).sum(), (xb,))
    assert dx.dtype == torch.bfloat16 and dx.shape == xb.shape
    xf = xb.detach().float().requires_grad_()
    (want,) = torch.autograd.grad(
        (fk.conv_bn_act_reference(xf, w, s, b) * ct).sum(), (xf,))
    # both rounded to bf16: one ulp (2**-7 relative) may part them
    np.testing.assert_allclose(dx.float().numpy(),
                               want.to(torch.bfloat16).float().numpy(),
                               atol=TOL, rtol=2 ** -7)
