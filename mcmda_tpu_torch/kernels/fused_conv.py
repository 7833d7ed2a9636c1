"""Fused stride-1 3x3 (dilated) conv + folded eval-BN + residual + activation.

Counterpart of ``mcmda_tpu/kernels/fused_conv.py``.  Eval-mode BN is an
affine in the channel dim (``fold_bn``), so every stride-1 residual conv of
the serving forward is one kernel: conv, ``* scale + bias``, optional
residual add and activation, with one store of the result.

- ``conv_bn_act_reference``: the plain PyTorch version, the oracle.
- ``conv_bn_act``: the wrapper the model calls.  A CPU tensor takes the plain
  version; a CUDA tensor launches the hand-written kernel
  (``csrc/fused_conv.cu``, on the main loop ``conv_tile.plan`` gives the
  shape) or raises.  There is no silent fallback.  Where
  autograd records and an input requires grad, the call goes through
  ``ConvBnAct`` (``conv_bn_act_vjp``), the JAX package's custom VJP: the
  same forward, the backward through transposed convs.  That form has no
  residual, as in the JAX package, so a residual there raises.

Dtypes: x and the residual may be f32 or bf16, w / scale / bias are f32, the
output is f32 -- what the oracle returns (the conv runs in f32), not the
TPU kernel's ``x.dtype`` output.
"""

from __future__ import annotations

import torch
from torch.nn import grad as nn_grad

from mcmda_tpu_torch.kernels import build, conv_tile
from mcmda_tpu_torch.ops import layers

# Kernel launches made by ``conv_bn_act``; callers reset and read it to show
# that a run really went through the kernel.
LAUNCHES = 0

_ACTIVATIONS = {"none": 0, "relu": 1, "leaky_relu": 2}
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn(bn_params, bn_state, eps: float = 1e-5):
    """Fold eval-mode BN into (scale, bias)."""
    scale = bn_params["scale"] * torch.rsqrt(bn_state["var"] + eps)
    bias = bn_params["bias"] - bn_state["mean"] * scale
    return scale, bias


def _activate(y, activation: str):
    if activation == "relu":
        return layers.relu(y)
    if activation == "leaky_relu":
        return layers.leaky_relu(y)
    if activation == "none":
        return y
    raise ValueError(activation)


def conv_bn_act_reference(x, w, scale, bias, *, dilation: int = 1,
                          activation: str = "relu", residual=None):
    """Plain PyTorch version: f32 SAME conv, affine, residual, activation."""
    y = layers.conv_apply({"w": w}, x, stride=1, dilation=dilation)
    y = y * scale + bias
    if residual is not None:
        y = y + residual
    return _activate(y, activation)


def _forward(x, w, scale, bias, dilation, activation, residual):
    """The dispatch on x's device: the plain version on the CPU, the kernel
    on a GPU, else raise."""
    if x.device.type == "cpu":
        return conv_bn_act_reference(x, w, scale, bias, dilation=dilation,
                                     activation=activation, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"conv_bn_act: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N,H,W,C], got {tuple(x.shape)}")
    if activation not in _ACTIVATIONS:
        raise ValueError(activation)
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    n, h, wd, c = x.shape
    k = w.shape[-1]
    f32 = (torch.float32,)
    build.check("x", x, (n, h, wd, c), _X_DTYPES, x.device)
    build.check("w", w, (3, 3, c, k), f32, x.device)
    build.check("scale", scale, (k,), f32, x.device)
    build.check("bias", bias, (k,), f32, x.device)
    if residual is not None:
        build.check("residual", residual, (n, h, wd, k), _X_DTYPES, x.device)
    if n * h * wd >= 2 ** 31:
        raise ValueError("conv_bn_act: N*H*W must fit a 32-bit int")

    out = torch.empty((n, h, wd, k), dtype=torch.float32, device=x.device)
    w_hi, w_lo = conv_tile.weight_scratch(
        conv_tile.plan_on_device(n, h, wd, c, k, x.dtype, x.device), c, k,
        x.device)
    build.launch(
        "mcmda_conv_bn_act", x.device, x.data_ptr(), _X_DTYPES[x.dtype],
        w.data_ptr(), None if w_hi is None else w_hi.data_ptr(),
        None if w_lo is None else w_lo.data_ptr(), scale.data_ptr(),
        bias.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        _X_DTYPES[residual.dtype] if residual is not None else 0,
        out.data_ptr(), n, h, wd, c, k, dilation, _ACTIVATIONS[activation])
    global LAUNCHES
    LAUNCHES += 1
    return out


class ConvBnAct(torch.autograd.Function):
    """The differentiable fused op, no residual form: the forward is
    ``conv_bn_act``'s dispatch (the kernel on a GPU), the backward the JAX
    package's ``fused_conv._bwd``.  The cotangent is masked by the
    activation on the saved output, taken through the affine, and
    cuDNN's transposed convs give dx (in x's dtype) and dw; dscale is
    sum(g * z) with z = conv(x, w) recomputed, dbias sum(g)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, dilation, activation):
        y = _forward(x, w, scale, bias, dilation, activation, None)
        ctx.save_for_backward(x, w, scale, y)
        ctx.dilation, ctx.activation = dilation, activation
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, scale, y = ctx.saved_tensors
        d = ctx.dilation
        if ctx.activation == "relu":
            g = torch.where(y > 0, g, 0.0)
        elif ctx.activation == "leaky_relu":
            g = torch.where(y > 0, g, 0.2 * g)
        xc = x.float().permute(0, 3, 1, 2)  # NCHW views of NHWC tensors
        gz = (g * scale).permute(0, 3, 1, 2)
        dx = dw = dscale = dbias = None
        # SAME padding of a stride-1 3x3 conv with dilation d is d per side
        if ctx.needs_input_grad[0]:
            dx = nn_grad.conv2d_input(
                xc.shape, w.permute(3, 2, 0, 1), gz, padding=d,
                dilation=d).permute(0, 2, 3, 1).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = nn_grad.conv2d_weight(
                xc, (w.shape[3], w.shape[2], w.shape[0], w.shape[1]), gz,
                padding=d, dilation=d).permute(2, 3, 1, 0)
        if ctx.needs_input_grad[2]:
            z = layers.conv_apply({"w": w}, x, stride=1, dilation=d)
            dscale = (g * z).sum((0, 1, 2))
        if ctx.needs_input_grad[3]:
            dbias = g.sum((0, 1, 2))
        return dx, dw, dscale, dbias, None, None


def conv_bn_act_vjp(x, w, scale, bias, dilation: int = 1,
                    activation: str = "relu"):
    """Differentiable ``conv_bn_act`` without residual (``ConvBnAct``)."""
    return ConvBnAct.apply(x, w, scale, bias, dilation, activation)


def conv_bn_act(x, w, scale, bias, *, dilation: int = 1,
                activation: str = "relu", residual=None):
    """x [N,H,W,C], w [3,3,C,K], scale/bias [K], residual [N,H,W,K] or
    None -> f32 [N,H,W,K].  CPU tensors: the plain version; CUDA tensors:
    the kernel.  Where autograd records and an input requires grad, the
    call is ``ConvBnAct``'s, which takes no residual."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, scale, bias, residual)):
        if residual is not None:
            raise ValueError(
                "conv_bn_act: the differentiable form has no residual (as "
                "the JAX package's custom VJP); call it without one, or "
                "under torch.no_grad() / torch.inference_mode()")
        return conv_bn_act_vjp(x, w, scale, bias, dilation, activation)
    return _forward(x, w, scale, bias, dilation, activation, residual)
