"""SAME 3x3 stride-1 conv of the thin 3-channel stem, NHWC in,
channels-first out, with its custom VJP and the channels-first BN + ReLU.

Counterpart of ``mcmda_tpu/kernels/thin_conv.py``.  As there, nothing in
``models/`` calls this module: the segmenter's stem is the plain conv of
``ops/layers``; the stem microbenchmark (``chip_smoke.py`` phase 7) is its
path on the card, as ``scripts/bench_stem.py`` is in the JAX package.

- ``stem_conv_cf_reference`` / ``stem_conv_nhwc_reference``: the plain
  PyTorch version (``F.conv2d`` on the channels-first padded input), the
  oracle.
- ``stem_conv_forward``: x [N,H,W,C] f32, w [3,3,C,K] f32 -> y [N,K,H,W]
  f32.  A CPU tensor takes the plain version; a CUDA tensor launches the
  hand-written kernel (``csrc/thin_conv.cu``) or raises.
- ``StemConv`` / ``stem_conv_nhwc``: differentiable.  dw is the nine
  slice contractions of the JAX ``stem_conv_dw_cf`` (plain torch, as the
  JAX package runs them in XLA); dx is None unless ``input_grad`` (the stem
  is the first layer), then the transposed conv.  A bf16 x runs the kernel
  in f32 and gets its dx back in bf16.
- ``bn_relu_cf`` and ``stem_apply_cf``: plain torch, the JAX state dicts in
  and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad

from mcmda_tpu_torch.kernels import build
from mcmda_tpu_torch.ops import layers

# Kernel launches made by ``stem_conv_forward``; callers reset and read it to
# show that a run really went through the kernel.
LAUNCHES = 0
_KS = (8, 16, 32)


def _pad_cf(x):
    """NHWC [N,H,W,C] -> SAME-padded channels-first [N,C,H+2,W+2] f32."""
    return F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1))


def _w27(w):
    """HWIO [3,3,C,K] -> tap-major [C*9, K], taps in (c, dy, dx) order."""
    return w.permute(2, 0, 1, 3).reshape(-1, w.shape[3])


def stem_conv_cf_reference(xp, w27):
    """xp [N,C,H+2,W+2] (pre-padded), w27 [C*9,K] -> y [N,K,H,W] f32."""
    cin = xp.shape[1]
    w_oihw = w27.float().reshape(cin, 3, 3, -1).permute(3, 0, 1, 2)
    return F.conv2d(xp.float(), w_oihw)


def stem_conv_nhwc_reference(x, w):
    """x [N,H,W,C], w [3,3,C,K] -> y [N,K,H,W] f32, plain PyTorch
    (differentiable by autograd)."""
    return stem_conv_cf_reference(_pad_cf(x), _w27(w))


def stem_conv_forward(x, w):
    """x [N,H,W,C] f32, w [3,3,C,K] f32 -> y [N,K,H,W] f32.  CPU tensors:
    the plain version; CUDA tensors: the kernel.  Not differentiable (see
    ``stem_conv_nhwc``)."""
    if x.device.type == "cpu":
        return stem_conv_nhwc_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N,H,W,C], got {tuple(x.shape)}")
    n, h, wd, c = x.shape
    k = w.shape[-1]
    if k not in _KS or not 1 <= c <= 16:
        raise ValueError(f"stem_conv: the kernel takes K in {_KS} and C <= "
                         f"16, got C={c}, K={k}")
    build.check("x", x, (n, h, wd, c), (torch.float32,), x.device)
    build.check("w", w, (3, 3, c, k), (torch.float32,), x.device)
    if n * h * wd >= 2 ** 31:
        raise ValueError("stem_conv: N*H*W must fit a 32-bit int")
    y = torch.empty((n, k, h, wd), dtype=torch.float32, device=x.device)
    build.launch("mcmda_stem_conv", x.device, x.data_ptr(), w.data_ptr(),
                 y.data_ptr(), n, h, wd, c, k)
    global LAUNCHES
    LAUNCHES += 1
    return y


def stem_conv_dw(x, g):
    """The weight cotangent: dw[dy,dx,c,k] = sum over (N,H,W) of the
    (dy,dx)-shifted padded input times g, nine contractions (the JAX
    ``stem_conv_dw_cf``).  x [N,H,W,C], g [N,K,H,W] -> dw [3,3,C,K] f32."""
    xp = _pad_cf(x)
    h, wd = g.shape[2], g.shape[3]
    g = g.float()
    return torch.stack([torch.stack([
        torch.einsum("nchw,nkhw->ck", xp[:, :, dy:dy + h, dx:dx + wd], g)
        for dx in range(3)]) for dy in range(3)])


class StemConv(torch.autograd.Function):
    """The custom VJP of the JAX ``stem_conv_nhwc``: dw by contraction, dx
    only when ``input_grad``."""

    @staticmethod
    def forward(ctx, x, w, input_grad):
        x32 = x.float().contiguous()
        ctx.save_for_backward(x32, w)
        ctx.input_grad = input_grad
        ctx.x_dtype = x.dtype
        return stem_conv_forward(x32, w.float().contiguous())

    @staticmethod
    def backward(ctx, g):
        x32, w = ctx.saved_tensors
        g = g.float()
        dx = None
        if ctx.input_grad and ctx.needs_input_grad[0]:
            dx = nn_grad.conv2d_input(
                (x32.shape[0], x32.shape[3], x32.shape[1], x32.shape[2]),
                w.float().permute(3, 2, 0, 1), g, padding=1)
            dx = dx.permute(0, 2, 3, 1).to(ctx.x_dtype)
        dw = stem_conv_dw(x32, g).to(w.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None


def stem_conv_nhwc(x, w, input_grad: bool = False):
    """SAME 3x3 conv, NHWC x [N,H,W,C] and HWIO w -> channels-first
    [N,K,H,W] f32; differentiable (``StemConv``)."""
    return StemConv.apply(x, w, input_grad)


def bn_relu_cf(params, state, y, train: bool, momentum: float = 0.99,
               eps: float = 1e-5, group=None):
    """Batch norm + ReLU of a channels-first [N,K,H,W] tensor, the
    semantics of ``layers.bn_apply_train`` / ``bn_apply`` reduced over
    (N,H,W) and, in train mode, the ranks of ``group`` (sync-BN); the state
    dict in and out is the NHWC path's."""
    y32 = y.float()
    if train:
        mean, mean2 = layers.sync_moments(
            y32.mean((0, 2, 3)), torch.square(y32).mean((0, 2, 3)), group)
        var = torch.clamp_min(mean2 - torch.square(mean), 0.0)
        with torch.no_grad():
            new_state = {"mean": momentum * state["mean"]
                         + (1 - momentum) * mean,
                         "var": momentum * state["var"]
                         + (1 - momentum) * var}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + eps) * params["scale"]
    out = (y32 - mean[:, None, None]) * inv[:, None, None] \
        + params["bias"][:, None, None]
    return torch.clamp_min(out, 0.0).to(y.dtype), new_state


def stem_apply_cf(p, st, x, *, train: bool, momentum: float, eps: float,
                  use_kernel: bool = True, input_grad: bool = False,
                  group=None):
    """The channels-first stem: conv -> BN + ReLU -> NHWC.  Returns
    (h [N,H,W,K], {"bn": new state}).  ``use_kernel=False`` runs the conv's
    plain version (with autograd's gradients) on any device; ``group`` syncs
    the train-mode BN over the ranks."""
    if use_kernel:
        y = stem_conv_nhwc(x, p["conv"]["w"], input_grad)
    else:
        y = stem_conv_nhwc_reference(x, p["conv"]["w"])
    y, bn_s = bn_relu_cf(p["bn"], st["bn"], y, train, momentum, eps, group)
    return y.permute(0, 2, 3, 1), {"bn": bn_s}
