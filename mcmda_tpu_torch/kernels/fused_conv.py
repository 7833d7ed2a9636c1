"""Fused stride-1 3x3 (dilated) conv + folded eval-BN + residual + activation.

Counterpart of ``mcmda_tpu/kernels/fused_conv.py``.  Eval-mode BN is an
affine in the channel dim (``fold_bn``), so every stride-1 residual conv of
the serving forward is one kernel: conv, ``* scale + bias``, optional
residual add and activation, with one store of the result.

- ``conv_bn_act_reference``: the plain PyTorch version, the oracle.
- ``conv_bn_act``: the wrapper the model calls.  A CPU tensor takes the plain
  version; a CUDA tensor launches the hand-written kernel
  (``csrc/fused_conv.cu``) or raises.  There is no silent fallback.

Dtypes: x and the residual may be f32 or bf16, w / scale / bias are f32, the
output is f32 -- what the oracle returns (the conv runs in f32), not the
TPU kernel's ``x.dtype`` output.
"""

from __future__ import annotations

import torch

from mcmda_tpu_torch.kernels import build
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


def conv_bn_act(x, w, scale, bias, *, dilation: int = 1,
                activation: str = "relu", residual=None):
    """x [N,H,W,C], w [3,3,C,K], scale/bias [K], residual [N,H,W,K] or
    None -> f32 [N,H,W,K].  CPU tensors: the plain version; CUDA tensors:
    the kernel."""
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
    build.launch(
        "mcmda_conv_bn_act", x.device, x.data_ptr(), _X_DTYPES[x.dtype],
        w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        _X_DTYPES[residual.dtype] if residual is not None else 0,
        out.data_ptr(), n, h, wd, c, k, dilation, _ACTIVATIONS[activation])
    global LAUNCHES
    LAUNCHES += 1
    return out
