"""Dilated-residual segmenter with the plug-and-play DAM split.

Counterpart of ``mcmda_tpu/models/segmenter.py``: stem conv -> strided
residual stages (x8 downsampling) -> dilated residual stages at 1/8
resolution -> 1x1 classifier -> x8 bilinear upsample -> softmax.

PnP-AdaNet's domain adaptation module (DAM) is the first stages up to
``plug_depth``: when ``dam_params`` is given, those stages read their
weights from it and the later stages read ``params``.  Params and BN state
are per-stage dicts of tensors (``weights.py`` loads them from the JAX
package's checkpoints).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mcmda_tpu_torch.config import SegmenterConfig, torch_dtype
from mcmda_tpu_torch.kernels import fused_conv as fk
from mcmda_tpu_torch.ops import blocks, layers


def init(cfg: SegmenterConfig, *, generator: torch.Generator | None = None,
         device=None):
    """(params, state) with the JAX package's tree layout and shapes: He-
    normal convs, identity BN.  Serving loads real weights over it."""
    params: Dict = {}
    state: Dict = {}
    cin = cfg.in_channels
    for spec in cfg.stages:
        if spec.name == "stem":
            p = {"conv": layers.conv_init(3, 3, cin, spec.features,
                                          generator=generator, device=device)}
            s = {}
            p["bn"], s["bn"] = layers.bn_init(spec.features, device)
            params[spec.name], state[spec.name] = p, s
        else:
            params[spec.name], state[spec.name] = blocks.stage_init(
                cin, spec, generator=generator, device=device)
        cin = spec.features
    params["head"] = layers.conv_init(1, 1, cin, cfg.num_classes,
                                      use_bias=True, generator=generator,
                                      device=device)
    return params, state


def _stage_params(params, dam_params, plug_depth, cfg: SegmenterConfig):
    """Yield (spec, stage params) with the DAM stages read from
    ``dam_params`` up to and including ``plug_depth``."""
    in_dam = dam_params is not None
    for spec in cfg.stages:
        yield spec, (dam_params if in_dam else params)[spec.name]
        if in_dam and plug_depth is not None and spec.name == plug_depth:
            in_dam = False  # hand off to the frozen higher layers


def apply(params, state, x, cfg: SegmenterConfig, *, train: bool = False,
          dam_params=None, plug_depth: str | None = None):
    """Forward pass (the JAX ``segmenter.apply``).

    ``train=True`` normalizes by batch statistics and returns updated BN
    state; under ``cfg.train_fused == "pallas"`` the wide tail's convs take
    the fused conv + BN-moments path (``ops/blocks.py``).  Eval mode uses
    the running statistics and returns ``state`` unchanged.

    x [N,H,W,C] -> (logits [N,H,W,classes] f32, probs = softmax(logits),
    taps {stage name: activation}, new_state)."""
    dtype = torch_dtype(cfg.compute_dtype)
    fused_train = cfg.train_fused == "pallas"
    taps: Dict[str, torch.Tensor] = {}
    new_state: Dict = {}
    h = x.to(dtype)
    for spec, p in _stage_params(params, dam_params, plug_depth, cfg):
        st = state[spec.name]
        if spec.name == "stem":
            h = layers.conv_apply(p["conv"], h, compute_dtype=dtype)
            if train:
                h, bn_s = layers.bn_apply_train(p["bn"], st["bn"], h,
                                                cfg.bn_momentum, cfg.bn_eps)
            else:
                h, bn_s = layers.bn_apply(p["bn"], st["bn"], h,
                                          cfg.bn_eps), st["bn"]
            h = layers.relu(h)
            new_state[spec.name] = {"bn": bn_s}
        else:
            h, new_state[spec.name] = blocks.stage_apply(
                p, st, h, spec, train=train, momentum=cfg.bn_momentum,
                eps=cfg.bn_eps, compute_dtype=dtype, fused_train=fused_train)
        taps[spec.name] = h
    logits = layers.conv_apply(params["head"], h, compute_dtype=dtype)
    logits = layers.bilinear_upsample(logits, cfg.total_stride).float()
    return logits, torch.softmax(logits, dim=-1), taps, new_state


def apply_fused_eval(params, state, x, cfg: SegmenterConfig, *,
                     dam_params=None, plug_depth: str | None = None,
                     use_kernel: bool = True):
    """Eval-mode forward on the fused path.

    The stem and every stride-1 residual conv run as one fused
    conv + BN-affine + activation call (the second conv of a block carrying
    the residual add): ``fused_conv.conv_bn_act``, which launches the CUDA
    kernel on a GPU, or with ``use_kernel=False`` its plain version.
    Strided blocks, 1x1 projections and the head are plain convs.

    The dtype flow is the JAX package's: the input is not cast, the fused
    calls return f32, strided blocks and the head run in
    ``cfg.compute_dtype``, and the logits are returned in it.

    Returns (logits, probs)."""
    conv_bn_act = fk.conv_bn_act if use_kernel else fk.conv_bn_act_reference
    dtype = torch_dtype(cfg.compute_dtype)
    h = x
    for spec, p in _stage_params(params, dam_params, plug_depth, cfg):
        st = state[spec.name]
        if spec.name == "stem":
            scale, bias = fk.fold_bn(p["bn"], st["bn"], cfg.bn_eps)
            h = conv_bn_act(h, p["conv"]["w"], scale, bias, dilation=1,
                            activation="relu")
            continue
        for i in range(spec.blocks):
            bp, bs = p[f"b{i}"], st[f"b{i}"]
            if i == 0 and spec.stride != 1:
                h, _ = blocks.residual_block_apply(
                    bp, bs, h, stride=spec.stride, dilation=spec.dilation,
                    eps=cfg.bn_eps, compute_dtype=dtype)
                continue
            s1, b1 = fk.fold_bn(bp["bn1"], bs["bn1"], cfg.bn_eps)
            s2, b2 = fk.fold_bn(bp["bn2"], bs["bn2"], cfg.bn_eps)
            h1 = conv_bn_act(h, bp["conv1"]["w"], s1, b1,
                             dilation=spec.dilation, activation="relu")
            if "proj" in bp:
                sp, bp_ = fk.fold_bn(bp["bn_p"], bs["bn_p"], cfg.bn_eps)
                sc = layers.conv_apply(bp["proj"], h) * sp + bp_
            else:
                sc = h
            h = conv_bn_act(h1, bp["conv2"]["w"], s2, b2,
                            dilation=spec.dilation, activation="relu",
                            residual=sc)
    logits = layers.conv_apply(params["head"], h, compute_dtype=dtype)
    logits = layers.bilinear_upsample(logits, cfg.total_stride)
    return logits, torch.softmax(logits, dim=-1)


# ------------------------------------------------------------- DAM plumbing
def dam_stage_names(cfg: SegmenterConfig, plug_depth: str) -> Tuple[str, ...]:
    names = []
    for spec in cfg.stages:
        names.append(spec.name)
        if spec.name == plug_depth:
            return tuple(names)
    raise ValueError(f"plug_depth {plug_depth!r} not a stage of the segmenter")


def dam_split(params, cfg: SegmenterConfig, plug_depth: str):
    """Split a full param tree into (dam, hlm) sub-trees by stage name."""
    dam_names = set(dam_stage_names(cfg, plug_depth))
    dam = {k: v for k, v in params.items() if k in dam_names}
    hlm = {k: v for k, v in params.items() if k not in dam_names}
    return dam, hlm


def dam_merge(dam_params, hlm_params):
    return {**hlm_params, **dam_params}
