"""Residual / dilated-residual blocks, eval mode.

Counterpart of the NHWC path of ``mcmda_tpu/ops/blocks.py``: conv-BN-ReLU ->
conv-BN, identity (or strided 1x1 projection) skip, final ReLU; dilation
applies to both convs.  The space-to-depth variants of the JAX package are
TPU layout devices with the same math and are not ported.

Per-block layout::

    params = {"conv1", "bn1", "conv2", "bn2", ["proj", "bn_p"]}
    state  = {"bn1", "bn2", ["bn_p"]}
"""

from __future__ import annotations

import torch

from mcmda_tpu_torch.ops import layers


def residual_block_init(cin: int, cout: int, stride: int = 1, *,
                        generator: torch.Generator | None = None,
                        device=None):
    params = {"conv1": layers.conv_init(3, 3, cin, cout, generator=generator,
                                        device=device),
              "conv2": layers.conv_init(3, 3, cout, cout, generator=generator,
                                        device=device)}
    state = {}
    params["bn1"], state["bn1"] = layers.bn_init(cout, device)
    params["bn2"], state["bn2"] = layers.bn_init(cout, device)
    if stride != 1 or cin != cout:
        params["proj"] = layers.conv_init(1, 1, cin, cout, generator=generator,
                                          device=device)
        params["bn_p"], state["bn_p"] = layers.bn_init(cout, device)
    return params, state


def residual_block_apply(params, state, x, *, stride: int = 1,
                         dilation: int = 1, eps: float = 1e-5,
                         compute_dtype: torch.dtype = torch.float32):
    h = layers.conv_apply(params["conv1"], x, stride=stride,
                          dilation=dilation, compute_dtype=compute_dtype)
    h = layers.relu(layers.bn_apply(params["bn1"], state["bn1"], h, eps))
    if "proj" in params:
        sc = layers.conv_apply(params["proj"], x, stride=stride,
                               compute_dtype=compute_dtype)
        sc = layers.bn_apply(params["bn_p"], state["bn_p"], sc, eps)
    else:
        sc = x
    h = layers.conv_apply(params["conv2"], h, dilation=dilation,
                          compute_dtype=compute_dtype)
    h = layers.bn_apply(params["bn2"], state["bn2"], h, eps)
    return layers.relu(h + sc)


def stage_init(cin: int, spec, *, generator: torch.Generator | None = None,
               device=None):
    """A stage = ``spec.blocks`` residual blocks; the first carries the
    stride / channel change."""
    params, state = {}, {}
    c = cin
    for i in range(spec.blocks):
        params[f"b{i}"], state[f"b{i}"] = residual_block_init(
            c, spec.features, stride=spec.stride if i == 0 else 1,
            generator=generator, device=device)
        c = spec.features
    return params, state


def stage_apply(params, state, x, spec, *, eps: float = 1e-5,
                compute_dtype: torch.dtype = torch.float32):
    for i in range(spec.blocks):
        x = residual_block_apply(params[f"b{i}"], state[f"b{i}"], x,
                                 stride=spec.stride if i == 0 else 1,
                                 dilation=spec.dilation, eps=eps,
                                 compute_dtype=compute_dtype)
    return x
