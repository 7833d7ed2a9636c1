"""Primitive layers of the segmenter's eval-mode forward, in PyTorch.

Counterpart of ``mcmda_tpu/ops/layers.py``.  The public layouts stay the
JAX package's: NHWC activations and HWIO weights, so both packages can be
fed the same arrays.  Internally each conv permutes to PyTorch's NCHW/OIHW.

Param/state convention: dicts of tensors, ``{"w": ..., ["b": ...]}`` for a
conv, ``{"scale", "bias"}`` params and ``{"mean", "var"}`` state for BN.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------- conv
def conv_init(kh: int, kw: int, cin: int, cout: int, use_bias: bool = False,
              *, generator: torch.Generator | None = None, device=None):
    """He-normal conv kernel (HWIO)."""
    w = torch.randn((kh, kw, cin, cout), generator=generator, device=device)
    p = {"w": w * math.sqrt(2.0 / (kh * kw * cin))}
    if use_bias:
        p["b"] = torch.zeros((cout,), device=device)
    return p


def same_padding(size: int, kernel: int, stride: int, dilation: int):
    """XLA's SAME padding for one spatial dim: (low, high), low = total // 2.

    PyTorch's ``padding=`` is symmetric; XLA puts the odd pixel on the high
    side, so a stride-2 3x3 conv on even input pads (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv_apply(p, x, stride: int = 1, dilation: int = 1,
               compute_dtype: torch.dtype = torch.float32):
    """SAME conv with optional stride / atrous dilation, NHWC in and out.

    Both operands are cast to ``compute_dtype`` and the output stays in it,
    as in the JAX package."""
    w = p["w"].to(compute_dtype)
    kh, kw = w.shape[0], w.shape[1]
    ph = same_padding(x.shape[1], kh, stride, dilation)
    pw = same_padding(x.shape[2], kw, stride, dilation)
    xc = x.to(compute_dtype).permute(0, 3, 1, 2)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride,
                     padding=(ph[0], pw[0]), dilation=dilation)
    else:
        y = F.conv2d(F.pad(xc, (pw[0], pw[1], ph[0], ph[1])),
                     w.permute(3, 2, 0, 1), stride=stride, dilation=dilation)
    # a no-op copy when the conv kept the channels-last memory format
    y = y.permute(0, 2, 3, 1).contiguous()
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ----------------------------------------------------------------- batchnorm
def bn_init(c: int, device=None):
    params = {"scale": torch.ones((c,), device=device),
              "bias": torch.zeros((c,), device=device)}
    state = {"mean": torch.zeros((c,), device=device),
             "var": torch.ones((c,), device=device)}
    return params, state


def bn_apply(params, state, x, eps: float = 1e-5):
    """Eval-mode batch norm from the running statistics, computed in f32
    and returned in ``x``'s dtype (the JAX ``bn_apply(train=False)``)."""
    inv = torch.rsqrt(state["var"] + eps) * params["scale"]
    y = (x.float() - state["mean"]) * inv + params["bias"]
    return y.to(x.dtype)


# --------------------------------------------------------------- activations
def relu(x):
    return torch.clamp_min(x, 0)


def leaky_relu(x, slope: float = 0.2):
    return torch.where(x >= 0, x, slope * x)


# ------------------------------------------------------------------ resizing
def bilinear_upsample(x, factor: int):
    """Bilinear upsample of NHWC logits by ``factor``.

    Half-pixel centres with edge clamping, which for upsampling is what
    ``jax.image.resize(..., "bilinear")`` computes (it drops out-of-range
    taps and renormalises, leaving the edge pixel's value)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=factor,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
