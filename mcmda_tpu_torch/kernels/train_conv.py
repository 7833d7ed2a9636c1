"""Stride-1 3x3 (dilated) conv + per-channel batch moments, for train-mode
BN in the wide dilated tail.

Counterpart of ``mcmda_tpu/kernels/train_conv.py``.  Train-mode BN needs
the batch statistics of the conv output z, so the conv's epilogue also sums
z and z^2 per output channel while the tile is in registers; the
normalize + residual + activation step after it is plain PyTorch
(``conv_bn_act_train``), as the JAX package leaves it to XLA.

- ``conv_stats_reference``: the plain PyTorch version, the oracle.
- ``conv_stats``: differentiable (``ConvStats``).  Its forward takes the
  plain version for a CPU tensor and launches the hand-written kernel
  (``csrc/train_conv.cu``, on the main loop ``conv_tile.plan`` gives the
  shape) for a CUDA tensor, or raises; no silent fallback.
  Its backward is the analytic VJP of the JAX package's custom VJP: the
  moments' cotangents collapse onto z, then dx and dw are the transposed
  convs, which PyTorch runs (the JAX package leaves them to XLA too).

The TPU kernel's VMEM gate (``fits``) and its TPU-availability test are
not ported: which convs take this path is decided by the caller
(``ops/blocks.py``) on the shape alone.
"""

from __future__ import annotations

import torch
from torch.nn import grad as nn_grad

from mcmda_tpu_torch.kernels import build, conv_tile
from mcmda_tpu_torch.ops import layers

# Kernel launches made by ``conv_stats``; callers reset and read it to show
# that a run really went through the kernel.
LAUNCHES = 0


def conv_stats_reference(x, w, dilation: int = 1):
    """(z, sum_c, sumsq_c) with plain PyTorch ops."""
    z = layers.conv_apply({"w": w}, x, stride=1, dilation=dilation)
    return z, z.sum((0, 1, 2)), torch.square(z).sum((0, 1, 2))


def conv_stats_forward(x, w, dilation: int = 1):
    """x [N,H,W,C] f32, w [3,3,C,K] f32 -> (z [N,H,W,K], sum [K],
    sumsq [K]).  CPU tensors: the plain version; CUDA tensors: the kernel.
    Not differentiable (see ``conv_stats``)."""
    if x.device.type == "cpu":
        return conv_stats_reference(x, w, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"conv_stats: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N,H,W,C], got {tuple(x.shape)}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    n, h, wd, c = x.shape
    k = w.shape[-1]
    build.check("x", x, (n, h, wd, c), (torch.float32,), x.device)
    build.check("w", w, (3, 3, c, k), (torch.float32,), x.device)
    if n * h * wd >= 2 ** 31:
        raise ValueError("conv_stats: N*H*W must fit a 32-bit int")

    # the partials' rows are the kernel's pixel tiles: ask the library, so
    # that this sizing and the tile cannot drift apart
    m_tiles = build.load().mcmda_conv_stats_partial_tiles(n * h * wd)
    z = torch.empty((n, h, wd, k), dtype=torch.float32, device=x.device)
    partial = torch.empty((m_tiles, 2, k), dtype=torch.float32,
                          device=x.device)
    s = torch.empty((k,), dtype=torch.float32, device=x.device)
    ss = torch.empty((k,), dtype=torch.float32, device=x.device)
    w_hi, w_lo = conv_tile.weight_scratch(
        conv_tile.plan_on_device(n, h, wd, c, k, x.dtype, x.device), c, k,
        x.device)
    build.launch("mcmda_conv_stats", x.device, x.data_ptr(), w.data_ptr(),
                 None if w_hi is None else w_hi.data_ptr(),
                 None if w_lo is None else w_lo.data_ptr(),
                 z.data_ptr(), partial.data_ptr(), s.data_ptr(),
                 ss.data_ptr(), n, h, wd, c, k, dilation)
    global LAUNCHES
    LAUNCHES += 1
    return z, s, ss


class ConvStats(torch.autograd.Function):
    """(z, sum, sumsq) of the SAME stride-1 conv, with the JAX package's
    analytic VJP (``train_conv._bwd``): sum is linear and sumsq quadratic in
    z, so their cotangents collapse onto the conv output as
    ``dz + ds + 2*z*dss``, whose transposed convs give dx and dw without
    re-running the forward conv."""

    @staticmethod
    def forward(ctx, x, w, dilation):
        z, s, ss = conv_stats_forward(x, w, dilation)
        ctx.save_for_backward(x, w, z)
        ctx.dilation = dilation
        ctx.set_materialize_grads(False)
        return z, s, ss

    @staticmethod
    def backward(ctx, dz, ds, dss):
        x, w, z = ctx.saved_tensors
        d = ctx.dilation
        dz_total = torch.zeros_like(z) if dz is None else dz
        if ds is not None:
            dz_total = dz_total + ds
        if dss is not None:
            dz_total = dz_total + 2.0 * z * dss
        g = dz_total.permute(0, 3, 1, 2)  # NCHW view of the NHWC cotangent
        dx = dw = None
        # SAME padding of a stride-1 3x3 conv with dilation d is d per side
        if ctx.needs_input_grad[0]:
            dx = nn_grad.conv2d_input(
                (x.shape[0], x.shape[3], x.shape[1], x.shape[2]),
                w.permute(3, 2, 0, 1), g, padding=d,
                dilation=d).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = nn_grad.conv2d_weight(
                x.permute(0, 3, 1, 2),
                (w.shape[3], w.shape[2], w.shape[0], w.shape[1]), g,
                padding=d, dilation=d).permute(2, 3, 1, 0)
        return dx, dw, None


def conv_stats(x, w, dilation: int = 1):
    """Differentiable fused conv + BN moments: (z, sum, sumsq)."""
    return ConvStats.apply(x, w, dilation)


def conv_bn_act_train(conv_p, bn_p, bn_state, x, *, dilation: int = 1,
                      activation: str = "relu", momentum: float = 0.99,
                      eps: float = 1e-5, residual=None, group=None):
    """conv -> train-mode BN -> (+ residual) -> activation, the BN moments
    taken from the fused conv: the analog of ``conv_apply`` +
    ``bn_apply_train`` [+ residual] + relu.  Under data parallelism the
    kernel's raw moments are averaged over the ranks of ``group`` before
    the normalisation (sync-BN; the kernel itself is per rank).  Returns
    (y, new BN state)."""
    z, s, ss = conv_stats(x, conv_p["w"], dilation)
    cnt = z.shape[0] * z.shape[1] * z.shape[2]
    y, new_state = layers.bn_normalize_train(bn_p, bn_state, z, s / cnt,
                                             ss / cnt, momentum, eps, group)
    if residual is not None:
        y = y + residual
    if activation == "relu":
        y = layers.relu(y)
    elif activation != "none":
        raise ValueError(activation)
    return y, new_state
