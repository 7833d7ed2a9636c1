"""Plain PyTorch reference of PnP-AdaNet as the benchmark runs it.

Dou et al., "PnP-AdaNet: Plug-and-play adversarial domain adaptation
network at unpaired cross-modality cardiac segmentation", IEEE Access 2019
(arXiv:1812.07907): a dilated residual segmenter (widths 16 -> 512, x8
stride, dilated tail), supervised source training with weighted
cross-entropy + soft Dice under Adam, and adaptation of the early stages
(the domain adaptation module, DAM, up to the plug depth) against a
feature-space PatchGAN critic with least-squares GAN losses.

Layouts are the public ones the benchmark hands to both sides: NHWC
activations, HWIO conv weights, params and BN state as nested dicts.  No
kernel, graph, cache or batching: every conv is ``F.conv2d`` (or a channel
product for 1x1), every statistic a plain reduction, every step eager.
TF32 stays off (``set_exact``).  ``rnd``, where a function takes it, rounds
the operands of every conv and matrix product first (``tf32_round``,
``fp8_round``): the lower-precision controls of the comparison.

The batch draws follow the published seed scheme of the recipe (numpy
``SeedSequence`` mixes of the run seed, the call and the inner step, then a
``torch.Generator`` on the data's device: batch indices, then five
uniform draws per image for flip, rotation, zoom and shift), so the
reference draws again what a run drew.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

Rounder = Optional[Callable[[torch.Tensor], torch.Tensor]]


def set_exact() -> None:
    """f32 products in f32: no TF32 in cuDNN or cuBLAS, deterministic
    cuDNN algorithms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


# ------------------------------------------------------------------ seeds
def step_key(root: int, step: int, purpose: int = 0) -> int:
    words = np.random.SeedSequence([int(root), purpose, int(step)]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def fold_in(seed: int, data: int) -> int:
    words = np.random.SeedSequence([int(seed), int(data)]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def inner_seed(run_seed: int, call: int, i: int, inner: int) -> int:
    """The generator seed of inner step ``i`` of call ``call`` of a run
    seeded ``run_seed`` that takes ``inner`` steps per call."""
    s = step_key(run_seed, call)
    return s if inner == 1 else fold_in(s, i)


# -------------------------------------------------------------- precision
def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), nearest even: the operand
    rounding of a TF32 tensor-core product."""
    if t.dtype != torch.float32:
        return t
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 quantisation, returned in ``t``'s
    dtype: the operand rounding of an fp8 product."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    s = amax / 448.0
    q = (t.float() / s).to(torch.float8_e4m3fn).float() * s
    return q.to(t.dtype)


class _LowpConv(torch.autograd.Function):
    """A conv whose forward and backward products take rounded operands."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, rnd):
        xr, wr = rnd(x), rnd(w)
        ctx.save_for_backward(xr, wr)
        ctx.cfg = (stride, padding, dilation, rnd)
        return F.conv2d(xr, wr, stride=stride, padding=padding,
                        dilation=dilation)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        stride, padding, dilation, rnd = ctx.cfg
        gx, gw, _ = torch.ops.aten.convolution_backward(
            rnd(g.contiguous()), xr, wr, None, [stride] * 2, list(padding),
            [dilation] * 2, False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None


class _LowpMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ar, br = rnd(a), rnd(b)
        ctx.save_for_backward(ar, br)
        ctx.rnd = rnd
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        g = ctx.rnd(g)
        ga = g @ br.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = None
        if ctx.needs_input_grad[1]:
            gb = (ar.reshape(-1, ar.shape[-1]).transpose(0, 1)
                  @ g.reshape(-1, g.shape[-1]))
        return ga, gb, None


def _matmul(a, b, rnd: Rounder):
    return a @ b if rnd is None else _LowpMatmul.apply(a, b, rnd)


def _conv2d(x, w, stride, padding, dilation, rnd: Rounder):
    if rnd is None:
        return F.conv2d(x, w, stride=stride, padding=padding,
                        dilation=dilation)
    return _LowpConv.apply(x, w, stride, tuple(padding), dilation, rnd)


# ----------------------------------------------------------------- layers
def same_padding(size: int, kernel: int, stride: int, dilation: int):
    """XLA's SAME padding of one dimension: (low, high), the odd pixel
    high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv(p, x, stride: int = 1, dilation: int = 1,
         dtype: torch.dtype = torch.float32, rnd: Rounder = None):
    """SAME conv, NHWC in and out, operands and output in ``dtype``."""
    w = p["w"].to(dtype)
    kh, kw = w.shape[0], w.shape[1]
    if kh == kw == 1:
        y = _matmul(x.to(dtype)[:, ::stride, ::stride, :], w[0, 0], rnd)
    else:
        ph = same_padding(x.shape[1], kh, stride, dilation)
        pw = same_padding(x.shape[2], kw, stride, dilation)
        xc = x.to(dtype).permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            y = _conv2d(xc, wc, stride, (ph[0], pw[0]), dilation, rnd)
        else:
            y = _conv2d(F.pad(xc, (pw[0], pw[1], ph[0], ph[1])), wc,
                        stride, (0, 0), dilation, rnd)
        y = y.permute(0, 2, 3, 1).contiguous()
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def bn_eval(p, s, x, eps: float):
    inv = torch.rsqrt(s["var"] + eps) * p["scale"]
    return ((x.float() - s["mean"]) * inv + p["bias"]).to(x.dtype)


def bn_train(p, s, x, momentum: float, eps: float):
    """Batch statistics over N, H, W in f32, biased variance E[x^2] -
    E[x]^2 clamped at 0; ``momentum`` is the share of the old running
    statistic kept.  -> (y in x's dtype, new running state)."""
    x32 = x.float()
    mean = x32.mean((0, 1, 2))
    var = torch.clamp_min(torch.square(x32).mean((0, 1, 2))
                          - torch.square(mean), 0.0)
    with torch.no_grad():
        new = {"mean": momentum * s["mean"] + (1 - momentum) * mean,
               "var": momentum * s["var"] + (1 - momentum) * var}
    y = (x32 - mean) * (torch.rsqrt(var + eps) * p["scale"]) + p["bias"]
    return y.to(x.dtype), new


def relu(x):
    return torch.clamp_min(x, 0)


def leaky_relu(x, slope: float = 0.2):
    return torch.where(x >= 0, x, slope * x)


def _interp_matrix(size: int, out: int, upsample: bool, device):
    """[out, size] bilinear weights of one axis, half-pixel centres: edge
    taps clamped when upsampling; the triangle widened by size / out and
    out-of-range taps dropped and renormalised when resizing down."""
    if upsample:
        factor = out // size
        src = (torch.arange(out, dtype=torch.float64) + 0.5) / factor - 0.5
        i0 = torch.floor(src)
        frac = src - i0
        i0 = i0.long()
        m = torch.zeros((out, size), dtype=torch.float64)
        rows = torch.arange(out)
        m.index_put_((rows, i0.clamp(0, size - 1)), 1.0 - frac,
                     accumulate=True)
        m.index_put_((rows, (i0 + 1).clamp(0, size - 1)), frac,
                     accumulate=True)
        return m.to(device=device, dtype=torch.float32)
    inv = size / out
    kscale = max(inv, 1.0)
    src = (torch.arange(out, dtype=torch.float64) + 0.5) * inv - 0.5
    d = (src[:, None] - torch.arange(size, dtype=torch.float64)[None, :]
         ).abs() / kscale
    m = torch.clamp_min(1.0 - d, 0.0)
    total = m.sum(1, keepdim=True)
    m = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    m / torch.where(total != 0, total, 1.0), 0.0)
    inside = (src >= -0.5) & (src <= size - 0.5)
    return torch.where(inside[:, None], m, 0.0).to(device=device,
                                                    dtype=torch.float32)


def _resize(x, hw, upsample: bool, rnd: Rounder = None):
    my = _interp_matrix(x.shape[1], hw[0], upsample, x.device)
    mx = _interp_matrix(x.shape[2], hw[1], upsample, x.device)
    if rnd is None:
        y = torch.einsum("oh,nhwc->nowc", my, x.float())
        y = torch.einsum("pw,nowc->nopc", mx, y)
    else:  # the same two products, through the rounding matmul
        y = _matmul(x.float().permute(0, 2, 3, 1), my.t(), rnd)
        y = _matmul(y.permute(0, 3, 2, 1), mx.t(), rnd).permute(0, 1, 3, 2)
    return y.to(x.dtype)


# --------------------------------------------------------------- segmenter
# (name, features, stride, dilation, blocks): the published stages
STAGES = (("stem", 16, 1, 1, 1), ("rm1", 32, 2, 1, 2), ("rm2", 64, 2, 1, 2),
          ("rm3", 128, 2, 1, 2), ("rm4", 256, 1, 2, 2),
          ("rm5", 512, 1, 2, 2), ("rm6", 512, 1, 4, 2))
TOTAL_STRIDE = 8
BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def segmenter_shapes(in_channels: int = 3, num_classes: int = 5):
    """{param path: shape} and {BN state path: shape} of the segmenter,
    paths as tuples of dict keys."""
    params, state = {}, {}

    def bn(prefix, c):
        params[prefix + ("scale",)] = params[prefix + ("bias",)] = (c,)
        state[prefix + ("mean",)] = state[prefix + ("var",)] = (c,)

    cin = in_channels
    for name, feat, stride, _, blocks in STAGES:
        if name == "stem":
            params[(name, "conv", "w")] = (3, 3, cin, feat)
            bn((name, "bn"), feat)
        else:
            c = cin
            for i in range(blocks):
                b = (name, f"b{i}")
                params[b + ("conv1", "w")] = (3, 3, c, feat)
                params[b + ("conv2", "w")] = (3, 3, feat, feat)
                bn(b + ("bn1",), feat)
                bn(b + ("bn2",), feat)
                if (stride if i == 0 else 1) != 1 or c != feat:
                    params[b + ("proj", "w")] = (1, 1, c, feat)
                    bn(b + ("bn_p",), feat)
                c = feat
        cin = feat
    params[("head", "w")] = (1, 1, cin, num_classes)
    params[("head", "b")] = (num_classes,)
    return params, state


def _block(p, s, x, stride, dilation, train, dtype, rnd,
           momentum=BN_MOMENTUM):
    def norm(name, h):
        if train:
            return bn_train(p[name], s[name], h, momentum, BN_EPS)
        return bn_eval(p[name], s[name], h, BN_EPS), s[name]

    new = {}
    h = conv(p["conv1"], x, stride, dilation, dtype, rnd)
    h, new["bn1"] = norm("bn1", h)
    h = relu(h)
    if "proj" in p:
        sc = conv(p["proj"], x, stride, 1, dtype, rnd)
        sc, new["bn_p"] = norm("bn_p", sc)
    else:
        sc = x
    h = conv(p["conv2"], h, 1, dilation, dtype, rnd)
    h, new["bn2"] = norm("bn2", h)
    return relu(h + sc), new


def _stage_weights(params, dam, plug_depth):
    in_dam = dam is not None
    for name, *_ in STAGES:
        yield (dam if in_dam else params)[name]
        if in_dam and name == plug_depth:
            in_dam = False


def forward(params, state, x, *, train: bool = False,
            dtype: torch.dtype = torch.float32, dam=None,
            plug_depth: str | None = None, rnd: Rounder = None,
            momentum: float = BN_MOMENTUM):
    """The segmenter: -> (logits f32, probs, taps, new BN state).  Train
    mode normalises by batch statistics in every stage (``momentum``: the
    share of the old running statistics the new state keeps); ``dam`` and
    ``plug_depth`` read the stages up to the plug depth from ``dam``."""
    taps, new_state = {}, {}
    h = x.to(dtype)
    for (name, _, stride, dilation, blocks), p in zip(
            STAGES, _stage_weights(params, dam, plug_depth)):
        s = state[name]
        if name == "stem":
            h = conv(p["conv"], h, 1, 1, dtype, rnd)
            if train:
                h, bn_s = bn_train(p["bn"], s["bn"], h, momentum, BN_EPS)
            else:
                h, bn_s = bn_eval(p["bn"], s["bn"], h, BN_EPS), s["bn"]
            h = relu(h)
            new_state[name] = {"bn": bn_s}
        else:
            new_state[name] = {}
            for i in range(blocks):
                h, new_state[name][f"b{i}"] = _block(
                    p[f"b{i}"], s[f"b{i}"], h, stride if i == 0 else 1,
                    dilation, train, dtype, rnd, momentum)
        taps[name] = h
    logits = conv(params["head"], h, 1, 1, dtype, rnd)
    hw = (logits.shape[1] * TOTAL_STRIDE, logits.shape[2] * TOTAL_STRIDE)
    logits = _resize(logits, hw, True, rnd).float()
    return logits, torch.softmax(logits, -1), taps, new_state


def _fold(p, s):
    scale = p["scale"] * torch.rsqrt(s["var"] + BN_EPS)
    return scale, p["bias"] - s["mean"] * scale


def _conv_bn_relu(x, w, bn_p, bn_s, dilation, rnd, residual=None):
    """Eval conv + folded BN (+ residual) + ReLU, the conv in f32."""
    scale, bias = _fold(bn_p, bn_s)
    y = conv({"w": w}, x, 1, dilation, torch.float32, rnd) * scale + bias
    if residual is not None:
        y = y + residual
    return relu(y)


def serve_forward(params, state, x, *, dtype: torch.dtype, dam=None,
                  plug_depth: str | None = None, rnd: Rounder = None):
    """The serving forward: eval-mode BN folded into the convs.  Every
    stride-1 residual conv and the stem compute in f32 (a bf16 input is
    widened), with BN, residual and ReLU after them in f32; strided
    blocks, the 1x1 classifier and the upsample take ``dtype``, and the
    probabilities are in it.  -> probs [N,H,W,classes]."""
    h = x
    for (name, _, stride, dilation, blocks), p in zip(
            STAGES, _stage_weights(params, dam, plug_depth)):
        s = state[name]
        if name == "stem":
            h = _conv_bn_relu(h, p["conv"]["w"], p["bn"], s["bn"], 1, rnd)
            continue
        for i in range(blocks):
            bp, bs = p[f"b{i}"], s[f"b{i}"]
            if i == 0 and stride != 1:
                h, _ = _block(bp, bs, h, stride, dilation, False, dtype, rnd)
                continue
            h1 = _conv_bn_relu(h, bp["conv1"]["w"], bp["bn1"], bs["bn1"],
                               dilation, rnd)
            if "proj" in bp:
                sp, bpb = _fold(bp["bn_p"], bs["bn_p"])
                sc = conv(bp["proj"], h, 1, 1, torch.float32, rnd) * sp + bpb
            else:
                sc = h
            h = _conv_bn_relu(h1, bp["conv2"]["w"], bp["bn2"], bs["bn2"],
                              dilation, rnd, residual=sc)
    logits = conv(params["head"], h, 1, 1, dtype, rnd)
    hw = (logits.shape[1] * TOTAL_STRIDE, logits.shape[2] * TOTAL_STRIDE)
    logits = _resize(logits, hw, True, rnd)
    return torch.softmax(logits, -1)


def serve_volume_probs(params, state, volume, *, dtype, batch: int,
                       context: int = 3, tta: bool = False, dam=None,
                       plug_depth=None, rnd: Rounder = None):
    """Class probabilities [S,H,W,classes] (f32) of a [S,H,W] device
    volume: each slice with its edge-clamped neighbours as channels, in
    batches of ``batch`` (the last padded with the last slice), averaged
    with the horizontal flip under ``tta``."""
    s = volume.shape[0]
    half = context // 2
    pad = (-s) % batch
    base = torch.cat([torch.arange(s, device=volume.device),
                      torch.full((pad,), s - 1, device=volume.device)])
    idx = torch.clamp(base[:, None] + torch.arange(
        -half, half + 1, device=volume.device)[None, :], 0, s - 1)
    out = []
    for i in range(0, idx.shape[0], batch):
        xb = volume[idx[i:i + batch]].permute(0, 2, 3, 1).contiguous()
        if tta:
            p2 = serve_forward(params, state, torch.cat([xb, xb.flip(2)]),
                               dtype=dtype, dam=dam, plug_depth=plug_depth,
                               rnd=rnd)
            p = 0.5 * (p2[:batch] + p2[batch:].flip(2))
        else:
            p = serve_forward(params, state, xb, dtype=dtype, dam=dam,
                              plug_depth=plug_depth, rnd=rnd)
        out.append(p.float())
    return torch.cat(out)[:s]


# ------------------------------------------------------------------ critic
CRITIC_WIDTHS = (64, 128, 256, 512)
CRITIC_STRIDES = (2, 2, 2, 1)
CRITIC_TAPS = ("rm4", "rm6")
COMPRESS = 64
LRELU = 0.2


def critic_shapes():
    feats = {name: f for name, f, *_ in STAGES}
    params = {}
    for t in CRITIC_TAPS:
        params[("compress", t, "w")] = (1, 1, feats[t], COMPRESS)
        params[("compress", t, "b")] = (COMPRESS,)
    c = COMPRESS * len(CRITIC_TAPS)
    for i, w in enumerate(CRITIC_WIDTHS):
        params[("stack", f"conv{i}", "w")] = (4, 4, c, w)
        params[("stack", f"conv{i}", "b")] = (w,)
        c = w
    params[("stack", "out", "w")] = (1, 1, c, 1)
    params[("stack", "out", "b")] = (1,)
    return params


def _instance_norm(x, eps: float = 1e-5):
    m = x.mean((1, 2), keepdim=True)
    v = torch.square(x - m).mean((1, 2), keepdim=True)
    return (x - m) * torch.rsqrt(v + eps)


def critic_logits(cp, taps, rnd: Rounder = None):
    """PatchGAN over the taps: 1x1 compression + leaky ReLU, resized to
    the coarsest tap's grid and concatenated, strided 4x4 convs with
    instance norm after the first, a 1x1 to patch logits -> [N, patches]."""
    comp = {t: leaky_relu(conv(cp["compress"][t], taps[t], rnd=rnd), LRELU)
            for t in CRITIC_TAPS}
    hw = min((comp[t].shape[1], comp[t].shape[2]) for t in CRITIC_TAPS)
    h = torch.cat([comp[t] if tuple(comp[t].shape[1:3]) == hw
                   else _resize(comp[t], hw, False, rnd)
                   for t in CRITIC_TAPS], -1)
    st = cp["stack"]
    for i, stride in enumerate(CRITIC_STRIDES):
        h = conv(st[f"conv{i}"], h, stride, rnd=rnd)
        if i > 0:
            h = _instance_norm(h)
        h = leaky_relu(h, LRELU)
    out = conv(st["out"], h, rnd=rnd)
    return out.reshape(out.shape[0], -1)


# ------------------------------------------------------------------ losses
def segmentation_loss(logits, probs, onehot):
    """Inverse-frequency weighted cross-entropy + soft Dice over the
    foreground classes -> (loss, xent, dice_loss)."""
    logp = torch.log_softmax(logits, -1)
    freq = onehot.mean((0, 1, 2))
    w = 1.0 / (freq + 1e-3)
    w = w / w.sum()
    pix_w = (onehot * w).sum(-1)
    xent = -(onehot * logp).sum(-1)
    xe = (pix_w * xent).sum() / (pix_w.sum() + 1e-8)
    p, t = probs[..., 1:].float(), onehot[..., 1:].float()
    dice = (2.0 * (p * t).sum((0, 1, 2)) + 1.0) / (
        p.sum((0, 1, 2)) + t.sum((0, 1, 2)) + 1.0)
    dl = 1.0 - dice.mean()
    return xe + dl, xe, dl


# -------------------------------------------------------------------- Adam
class Adam:
    """Adam with bias correction ``1 - b ** count`` in f32, eps outside the
    root, and the rate ``lr`` or, under the cosine schedule, ``lr (1 +
    cos(pi min(t, T) / T)) / 2`` at 0-based update t of T.  Leaves are flat
    {path: tensor} dicts."""

    def __init__(self, lr, b1, b2, total_steps, schedule: str = "cosine",
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.total, self.eps = \
            lr, b1, b2, total_steps, eps
        self.cosine = schedule == "cosine" and total_steps > 0

    def init(self, params):
        dev = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    @torch.no_grad()
    def step(self, params, grads, opt, gate=None):
        """-> (new params, new state).  ``gate`` (a bool tensor): where it
        is false the update is a no-op, the state's count included."""
        b1, b2 = self.b1, self.b2
        t = opt["count"]
        mu = {k: (1 - b1) * g + b1 * opt["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * torch.square(g) + b2 * opt["nu"][k]
              for k, g in grads.items()}
        c = (t + 1).float()
        bc1 = 1 - torch.full_like(c, b1) ** c
        bc2 = 1 - torch.full_like(c, b2) ** c
        rate = self.lr
        if self.cosine:
            tt = torch.clamp(t, max=self.total).float()
            rate = self.lr * (0.5 * (1.0 + torch.cos(math.pi * tt
                                                     / self.total)))
        upd = {k: -rate * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                            + self.eps)) for k in params}
        if gate is not None:
            upd = {k: u * gate.to(u.dtype) for k, u in upd.items()}
            mu = {k: torch.where(gate, v, opt["mu"][k]) for k, v in mu.items()}
            nu = {k: torch.where(gate, v, opt["nu"][k]) for k, v in nu.items()}
            t = torch.where(gate, t + 1, t)
        else:
            t = t + 1
        return ({k: p + upd[k] for k, p in params.items()},
                {"count": t, "mu": mu, "nu": nu})


# -------------------------------------------------------- batch and warp
def draw_params(gen, batch: int, device, rotate_degrees: float,
                zoom_range, shift_pixels: float):
    u = torch.rand((batch, 5), generator=gen, device=device)
    flip = (u[:, 0] < 0.5).float()
    theta = (u[:, 1] * 2.0 - 1.0) * (rotate_degrees * math.pi / 180.0)
    lo, hi = zoom_range
    zoom = lo + (hi - lo) * u[:, 2]
    sy = -shift_pixels + 2.0 * shift_pixels * u[:, 3]
    sx = -shift_pixels + 2.0 * shift_pixels * u[:, 4]
    return flip, theta, zoom, sy, sx


def warp(images, draws, n_image: int):
    """The flip, rotation, zoom and shift about the centre as one inverse
    affine map per image, ``ys = c0*y + c1*x + c2``, ``xs = c3*y + c4*x +
    c5`` (a flip sampling the image at w-1-xs, folded into the x row),
    sampled bilinearly with edge-clamped corners and 0 outside; channels
    from ``n_image`` on (one-hot labels) renormalised to sum 1."""
    flip, theta, zoom, sy, sx = draws
    b, h, w, _ = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    inv = 1.0 / zoom
    ay, by = cos * inv, -sin * inv
    c_y = -ay * cy - by * cx + cy - sy
    ax, bx = sin * inv, cos * inv
    c_x = -ax * cy - bx * cx + cx - sx
    sign = 1.0 - 2.0 * flip
    ax, bx = ax * sign, bx * sign
    c_x = c_x * sign + flip * (w - 1)
    c = torch.stack([ay, by, c_y, ax, bx, c_x], -1)[:, :, None, None]
    yy = torch.arange(h, dtype=torch.float32, device=images.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=images.device)[None, :]
    ys = c[:, 0] * yy + c[:, 1] * xx + c[:, 2]
    xs = c[:, 3] * yy + c[:, 4] * xx + c[:, 5]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    valid = ((ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1))[..., None]
    y0c, x0c = y0.clamp(0, h - 1).long(), x0.clamp(0, w - 1).long()
    y1c, x1c = (y0c + 1).clamp_max(h - 1), (x0c + 1).clamp_max(w - 1)
    bi = torch.arange(b, device=images.device)[:, None, None]
    v = ((1 - wy) * (1 - wx) * images[bi, y0c, x0c]
         + (1 - wy) * wx * images[bi, y0c, x1c]
         + wy * (1 - wx) * images[bi, y1c, x0c]
         + wy * wx * images[bi, y1c, x1c])
    out = torch.where(valid, v, torch.zeros((), device=images.device))
    if n_image < out.shape[-1]:
        lab = out[..., n_image:]
        lab = lab / torch.clamp_min(lab.sum(-1, keepdim=True), 1e-6)
        out = torch.cat([out[..., :n_image], lab], -1)
    return out


# ------------------------------------------------------------ tree helpers
def flat(tree, prefix=()):
    """{path tuple: tensor} of a nested dict."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def nest(leaves):
    out: dict = {}
    for path, v in leaves.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out
