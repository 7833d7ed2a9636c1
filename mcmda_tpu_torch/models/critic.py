"""Feature-space PatchGAN domain critic (counterpart of
``mcmda_tpu/models/critic.py``).

The critic classifies source against target in FEATURE space: each tap
(a stage activation of the segmenter) is channel-compressed by a 1x1 conv
and leaky ReLU, resized to the coarsest tap's grid and concatenated
(``mode="concat"``), or each tap gets its own critic stack (``"multi"``).
A stack is strided 4x4 conv + instance norm (not on the first conv) +
leaky ReLU stages, then a 1x1 conv to per-patch logits.  The 4x4 convs pad
SAME as XLA does (``layers.conv_apply``): the stride-1 last conv on a 4x4
grid pads (1, 2).  Params are the JAX package's tree of HWIO dicts.
"""

from __future__ import annotations

from typing import Dict

import torch

from mcmda_tpu_torch.config import CriticConfig, SegmenterConfig
from mcmda_tpu_torch.ops import layers


def _instance_norm(x, eps: float = 1e-5):
    """Per-sample, per-channel normalisation over H, W with the biased
    variance (``jnp.var``)."""
    m = x.mean((1, 2), keepdim=True)
    v = torch.square(x - m).mean((1, 2), keepdim=True)
    return (x - m) * torch.rsqrt(v + eps)


def tap_channels(seg_cfg: SegmenterConfig) -> Dict[str, int]:
    return {s.name: s.features for s in seg_cfg.stages}


def _stack_init(cin: int, cfg: CriticConfig, generator, device):
    p = {}
    c = cin
    for i, w in enumerate(cfg.widths):
        p[f"conv{i}"] = layers.conv_init(4, 4, c, w, use_bias=True,
                                         generator=generator, device=device)
        c = w
    p["out"] = layers.conv_init(1, 1, c, 1, use_bias=True,
                                generator=generator, device=device)
    return p


def _stack_apply(p, x, cfg: CriticConfig):
    h = x
    for i in range(len(cfg.widths)):
        h = layers.conv_apply(p[f"conv{i}"], h, stride=cfg.strides[i])
        if i > 0:  # no norm on the first stage (PatchGAN convention)
            h = _instance_norm(h)
        h = layers.leaky_relu(h, cfg.lrelu_slope)
    return layers.conv_apply(p["out"], h)  # [N,h,w,1] patch logits


def init(cfg: CriticConfig, seg_cfg: SegmenterConfig, *,
         generator: torch.Generator | None = None, device=None):
    """The critic's params with the JAX tree layout and shapes (He-normal
    convs, zero biases)."""
    chans = tap_channels(seg_cfg)
    for t in cfg.taps:
        if t not in chans:
            raise ValueError(f"critic tap {t!r} is not a segmenter stage")
    params = {"compress": {
        t: layers.conv_init(1, 1, chans[t], cfg.compress_features,
                            use_bias=True, generator=generator, device=device)
        for t in cfg.taps}}
    if cfg.mode == "concat":
        params["stack"] = _stack_init(cfg.compress_features * len(cfg.taps),
                                      cfg, generator, device)
    elif cfg.mode == "multi":
        params["stacks"] = {t: _stack_init(cfg.compress_features, cfg,
                                           generator, device)
                            for t in cfg.taps}
    else:
        raise ValueError(f"unknown critic mode {cfg.mode!r}")
    return params


def apply(params, taps: Dict[str, torch.Tensor], cfg: CriticConfig):
    """taps: {stage name: NHWC activation}.  Returns patch logits [N,h,w,1]
    (concat mode) or a dict of them (multi mode); ``flatten_logits`` treats
    both alike."""
    comp = {}
    for t in cfg.taps:
        h = layers.conv_apply(params["compress"][t], taps[t])
        comp[t] = layers.leaky_relu(h, cfg.lrelu_slope)
    if cfg.mode == "concat":
        min_hw = min((comp[t].shape[1], comp[t].shape[2]) for t in cfg.taps)
        aligned = [comp[t] if tuple(comp[t].shape[1:3]) == min_hw
                   else layers.resize_to(comp[t], min_hw) for t in cfg.taps]
        return _stack_apply(params["stack"], torch.cat(aligned, -1), cfg)
    return {t: _stack_apply(params["stacks"][t], comp[t], cfg)
            for t in cfg.taps}


def flatten_logits(out):
    """Patch logits (a tensor or a per-tap dict) as one flat row per batch
    element, so the GAN losses do not depend on the mode."""
    if isinstance(out, dict):
        return torch.cat([v.reshape(v.shape[0], -1) for v in out.values()],
                         1)
    return out.reshape(out.shape[0], -1)
