"""Residual / dilated-residual blocks, eval and train mode.

Counterpart of the NHWC path of ``mcmda_tpu/ops/blocks.py``: conv-BN-ReLU ->
conv-BN, identity (or strided 1x1 projection) skip, final ReLU; dilation
applies to both convs.  The space-to-depth variants of the JAX package are
TPU layout devices with the same math and are not ported.

In train mode with ``fused_train`` (``segmenter.train_fused="pallas"``) the
convs the JAX package sends to its Pallas conv + BN-moments kernel go to
``kernels/train_conv.conv_bn_act_train``: stride 1, f32 compute, 3x3, and
input and output channels multiples of 128 -- at the default stages 15
convs per forward: the 3 stride-1 convs of rm3 and the 12 of rm4-rm6.  The
TPU kernel's VMEM-size gate has no counterpart here.

Per-block layout::

    params = {"conv1", "bn1", "conv2", "bn2", ["proj", "bn_p"]}
    state  = {"bn1", "bn2", ["bn_p"]}
"""

from __future__ import annotations

import torch

from mcmda_tpu_torch.kernels import train_conv
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


def _fused_ok(fused_train: bool, train: bool, stride: int, compute_dtype,
              w_shape) -> bool:
    """Whether a conv with HWIO weights of ``w_shape`` takes the fused
    conv + BN-moments path (``mcmda_tpu/kernels/train_conv.py:152-154``,
    ``blocks.py:51-60``)."""
    kh, kw, cin, cout = w_shape
    return (fused_train and train and stride == 1
            and compute_dtype == torch.float32 and (kh, kw) == (3, 3)
            and cin % 128 == 0 and cout % 128 == 0)


def residual_block_apply(params, state, x, *, stride: int = 1,
                         dilation: int = 1, train: bool = False,
                         momentum: float = 0.99, eps: float = 1e-5,
                         compute_dtype: torch.dtype = torch.float32,
                         fused_train: bool = False):
    """One block -> (output, new BN state).  Eval mode returns the running
    statistics unchanged; train mode normalizes by batch statistics and
    returns updated ones."""
    def bn(name, h):
        if train:
            return layers.bn_apply_train(params[name], state[name], h,
                                         momentum, eps)
        return layers.bn_apply(params[name], state[name], h, eps), \
            state[name]

    new_state = {}
    if _fused_ok(fused_train, train, stride, compute_dtype,
                 params["conv1"]["w"].shape):
        h, new_state["bn1"] = train_conv.conv_bn_act_train(
            params["conv1"], params["bn1"], state["bn1"],
            x.float().contiguous(), dilation=dilation, activation="relu",
            momentum=momentum, eps=eps)
    else:
        h = layers.conv_apply(params["conv1"], x, stride=stride,
                              dilation=dilation, compute_dtype=compute_dtype)
        h, new_state["bn1"] = bn("bn1", h)
        h = layers.relu(h)
    if "proj" in params:
        sc = layers.conv_apply(params["proj"], x, stride=stride,
                               compute_dtype=compute_dtype)
        sc, new_state["bn_p"] = bn("bn_p", sc)
    else:
        sc = x
    if _fused_ok(fused_train, train, 1, compute_dtype,
                 params["conv2"]["w"].shape):
        out, new_state["bn2"] = train_conv.conv_bn_act_train(
            params["conv2"], params["bn2"], state["bn2"],
            h.float().contiguous(), dilation=dilation, activation="relu",
            momentum=momentum, eps=eps, residual=sc.float())
        return out, new_state
    h = layers.conv_apply(params["conv2"], h, dilation=dilation,
                          compute_dtype=compute_dtype)
    h, new_state["bn2"] = bn("bn2", h)
    return layers.relu(h + sc), new_state


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


def stage_apply(params, state, x, spec, *, train: bool = False,
                momentum: float = 0.99, eps: float = 1e-5,
                compute_dtype: torch.dtype = torch.float32,
                fused_train: bool = False):
    """-> (output, new BN state of the stage)."""
    new_state = {}
    for i in range(spec.blocks):
        x, new_state[f"b{i}"] = residual_block_apply(
            params[f"b{i}"], state[f"b{i}"], x,
            stride=spec.stride if i == 0 else 1, dilation=spec.dilation,
            train=train, momentum=momentum, eps=eps,
            compute_dtype=compute_dtype, fused_train=fused_train)
    return x, new_state
