"""Primitive layers of the segmenter's forward, in PyTorch.

Counterpart of ``mcmda_tpu/ops/layers.py``.  The public layouts stay the
JAX package's: NHWC activations and HWIO weights, so both packages can be
fed the same arrays.  Internally each conv permutes to PyTorch's NCHW/OIHW.

Param/state convention: dicts of tensors, ``{"w": ..., ["b": ...]}`` for a
conv, ``{"scale", "bias"}`` params and ``{"mean", "var"}`` state for BN.

Train-mode BN takes the data-parallel process group ``group`` (the JAX
``axis_name``; None on one device): sync-BN averages the raw moments E[x]
and E[x^2] over the ranks before it normalizes.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from mcmda_tpu_torch.parallel import dp


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
    as in the JAX package.  A 1x1 conv never pads under SAME, so it is the
    channel product of the strided pixels, taken in NHWC directly (PyTorch's
    CPU backward of a channels-last strided 1x1 conv crashes)."""
    w = p["w"].to(compute_dtype)
    kh, kw = w.shape[0], w.shape[1]
    if kh == kw == 1:
        y = x.to(compute_dtype)[:, ::stride, ::stride, :] @ w[0, 0]
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        return y
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


def sync_moments(mean, mean2, group=None):
    """Sync-BN: the moments E[x] and E[x^2] of equal shards averaged over
    the ranks of ``group`` in one all-reduce (``dp.global_mean``, whose
    backward averages the cotangents); unchanged on one device."""
    if group is None:
        return mean, mean2
    return dp.global_mean(torch.stack([mean, mean2]), group).unbind()


def bn_normalize_train(params, state, x32, mean, mean2,
                       momentum: float = 0.99, eps: float = 1e-5,
                       group=None):
    """Train-mode BN of the f32 ``x32`` from its batch moments E[x] and
    E[x^2] (of this rank's shard: they are synced over ``group`` here) ->
    (y f32, new running state).

    The variance is the biased ``E[x^2] - E[x]^2`` clamped at 0, used both to
    normalize and to update the running statistics, and ``momentum`` is the
    fraction of the old statistic kept -- the JAX package's semantics, not
    ``F.batch_norm``'s (unbiased running variance, momentum 0.01).  The new
    state carries no autograd history."""
    mean, mean2 = sync_moments(mean, mean2, group)
    var = torch.clamp_min(mean2 - torch.square(mean), 0.0)
    with torch.no_grad():
        new_state = {
            "mean": momentum * state["mean"] + (1.0 - momentum) * mean,
            "var": momentum * state["var"] + (1.0 - momentum) * var,
        }
    y = (x32 - mean) * (torch.rsqrt(var + eps) * params["scale"]) \
        + params["bias"]
    return y, new_state


def bn_apply_train(params, state, x, momentum: float = 0.99,
                   eps: float = 1e-5, group=None):
    """Train-mode batch norm (the JAX ``bn_apply(train=True)``): batch
    statistics over N,H,W (and the ranks of ``group``) in f32, output in
    ``x``'s dtype, and the updated running state returned, never written in
    place."""
    x32 = x.float()
    mean = x32.mean((0, 1, 2))
    mean2 = torch.square(x32).mean((0, 1, 2))
    y, new_state = bn_normalize_train(params, state, x32, mean, mean2,
                                      momentum, eps, group)
    return y.to(x.dtype), new_state


# --------------------------------------------------------------- activations
def relu(x):
    return torch.clamp_min(x, 0)


def leaky_relu(x, slope: float = 0.2):
    return torch.where(x >= 0, x, slope * x)


# ------------------------------------------------------------------ resizing
@functools.lru_cache(maxsize=None)
def _upsample_matrix(size: int, factor: int, device) -> torch.Tensor:
    """[size*factor, size] f32 interpolation weights of one axis: half-pixel
    centres, the two taps of each output edge-clamped.  Built outside
    inference mode, so that a matrix first cached by a serving call can
    still take part in a training forward."""
    with torch.inference_mode(False):
        src = (torch.arange(size * factor, dtype=torch.float64) + 0.5) \
            / factor - 0.5
        i0 = torch.floor(src)
        frac = src - i0
        i0 = i0.long()
        m = torch.zeros((size * factor, size), dtype=torch.float64)
        rows = torch.arange(size * factor)
        m.index_put_((rows, i0.clamp(0, size - 1)), 1.0 - frac,
                     accumulate=True)
        m.index_put_((rows, (i0 + 1).clamp(0, size - 1)), frac,
                     accumulate=True)
        return m.to(device=device, dtype=torch.float32)


def bilinear_upsample(x, factor: int):
    """Bilinear upsample of NHWC logits by ``factor``, computed in f32 and
    returned in ``x``'s dtype.

    Half-pixel centres with edge clamping, which for upsampling is what
    ``jax.image.resize(..., "bilinear")`` computes (it drops out-of-range
    taps and renormalises, leaving the edge pixel's value).  Written as two
    products with the per-axis weight matrices, whose gradients are
    products too: ``F.interpolate``'s CUDA backward accumulates with atomics
    and would make a seeded training run unrepeatable."""
    my = _upsample_matrix(x.shape[1], factor, x.device)
    mx = _upsample_matrix(x.shape[2], factor, x.device)
    y = torch.einsum("oh,nhwc->nowc", my, x.float())
    y = torch.einsum("pw,nowc->nopc", mx, y)
    return y.to(x.dtype)


def avg_pool(x, factor: int):
    """Average-pool downsample of NHWC ``x`` by ``factor`` (VALID windows)."""
    if factor == 1:
        return x
    y = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), factor)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x):
    return x.mean((1, 2))


@functools.lru_cache(maxsize=None)
def _resize_matrix(size: int, out: int, device) -> torch.Tensor:
    """[out, size] f32 weights of ``jax.image.resize(method="bilinear")``
    along one axis (``compute_weight_mat`` of jax's scale module): half-pixel
    centres, the triangle kernel widened by size/out when it downsamples
    (antialiasing), out-of-range taps dropped and the rest renormalised.
    Built outside inference mode, as ``_upsample_matrix``."""
    with torch.inference_mode(False):
        inv = size / out
        kscale = max(inv, 1.0)
        src = (torch.arange(out, dtype=torch.float64) + 0.5) * inv - 0.5
        x = (src[:, None] - torch.arange(size, dtype=torch.float64)[None, :]
             ).abs() / kscale
        m = torch.clamp_min(1.0 - x, 0.0)
        total = m.sum(1, keepdim=True)
        m = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                        m / torch.where(total != 0, total, 1.0), 0.0)
        inside = (src >= -0.5) & (src <= size - 0.5)
        return torch.where(inside[:, None], m, 0.0).to(device=device,
                                                       dtype=torch.float32)


def resize_to(x, hw):
    """Bilinear resize of NHWC ``x`` to ``hw`` = (H, W), as
    ``jax.image.resize(..., method="bilinear")``: antialiased when it
    downsamples.  Two products with per-axis weight matrices, computed in
    f32 and returned in ``x``'s dtype; their gradients are products too."""
    my = _resize_matrix(x.shape[1], hw[0], x.device)
    mx = _resize_matrix(x.shape[2], hw[1], x.device)
    y = torch.einsum("oh,nhwc->nowc", my, x.float())
    y = torch.einsum("pw,nowc->nopc", mx, y)
    return y.to(x.dtype)
