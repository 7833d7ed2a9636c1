"""FLOPs of a train step and of a serving forward, counted on the
reference's own code run over meta tensors (shapes only, no memory).

The convention is XLA's ``HloCostAnalysis``, the one the recipe's FLOP
figures have always used: 2 per multiply-add of every convolution and
matrix product, a conv tap only where it falls inside the input (SAME
padding's zero taps are not work), each backward conv counted as autograd
runs it (no weight gradient of a frozen tensor, no input gradient of the
image), elementwise work not counted.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from benchmark.reference import pnp_adanet as ref
from benchmark.reference import train as ref_train

_aten = torch.ops.aten


def valid_taps(n_in: int, n_out: int, k: int, stride: int, pad_lo: int,
               dilation: int) -> int:
    """(output position, tap) pairs of one spatial dimension whose input
    index ``o * stride + t * dilation - pad_lo`` falls inside [0, n_in)."""
    n = 0
    for t in range(k):
        off = t * dilation - pad_lo
        lo = max(0, -(off // stride))
        hi = min(n_out, (n_in - 1 - off) // stride + 1) if n_in > off else 0
        n += max(0, hi - lo)
    return n


class TapCounter:
    """``FlopCounterMode``'s custom mapping for the valid-tap count.  An
    explicit zero pad in front of a conv (the asymmetric SAME pad) is
    remembered, and its rows and columns count as outside the image in
    the conv and in its backward."""

    def __init__(self):
        self.pads = WeakIdKeyDictionary()

    def mapping(self) -> dict:
        def raw(method):
            def fn(*args, **kwargs):
                return method(*args, **kwargs)
            fn._get_raw = True
            return fn
        return {_aten.constant_pad_nd: raw(self._pad),
                _aten.convolution: raw(self._conv),
                _aten._convolution: raw(self._conv),
                _aten.convolution_backward: raw(self._conv_backward)}

    def _pad(self, x, pad, value=0.0, *, out_val):
        pad = list(pad)
        if value == 0 and all(p >= 0 for p in pad):
            prev = self.pads.get(x, {})
            got = dict(prev)
            for i in range(len(pad) // 2):
                dim = x.dim() - 1 - i
                lo, hi = prev.get(dim, (0, 0))
                got[dim] = (lo + pad[2 * i], hi + pad[2 * i + 1])
            self.pads[out_val] = got
        return 0

    def _flops(self, x, w, stride, padding, dilation, out_hw) -> int:
        pads = self.pads.get(x, {})
        n = 2 * x.shape[0] * w.shape[0] * w.shape[1]
        for i, n_out in enumerate(out_hw):
            lo, hi = pads.get(2 + i, (0, 0))
            n *= valid_taps(x.shape[2 + i] - lo - hi, n_out, w.shape[2 + i],
                            stride[i], padding[i] + lo, dilation[i])
        return n

    def _conv(self, x, w, bias, stride, padding, dilation, transposed,
              output_padding, groups, *rest, out_val):
        if transposed:
            raise ValueError("the valid-tap count has no transposed conv")
        return self._flops(x, w, stride, padding, dilation, out_val.shape[2:])

    def _conv_backward(self, grad_out, x, w, bias_sizes, stride, padding,
                       dilation, transposed, output_padding, groups,
                       output_mask, *, out_val):
        if transposed:
            raise ValueError("the valid-tap count has no transposed conv")
        per = self._flops(x, w, stride, padding, dilation, grad_out.shape[2:])
        return per * (int(output_mask[0]) + int(output_mask[1]))


def count(fn) -> int:
    counter = FlopCounterMode(display=False,
                              custom_mapping=TapCounter().mapping())
    with counter:
        fn()
    return int(counter.get_total_flops())


def _meta(shapes: dict):
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


def _meta_segmenter():
    p, s = ref.segmenter_shapes()
    return _meta(p), ref.nest(_meta(s))


def _images(batch: int, size: int, channels: int = 3):
    return torch.empty((batch, size, size, channels), device="meta")


@functools.lru_cache(maxsize=None)
def source_step(batch: int, size: int) -> int:
    """FLOPs of one T1 step at ``batch`` slices of ``size``^2."""
    params, bn = _meta_segmenter()
    image, onehot = _images(batch, size), _images(batch, size, 5)
    return count(lambda: ref_train.source_grads(params, bn, image, onehot))


@functools.lru_cache(maxsize=None)
def adapt_step(batch: int, size: int, plug_depth: str) -> int:
    """FLOPs of one T2 step (one critic step, one DAM step off the shared
    target forward) at ``batch`` slices per domain."""
    params, bn = _meta_segmenter()
    dam_names = []
    for name, *_ in ref.STAGES:
        dam_names.append(name)
        if name == plug_depth:
            break
    critic = _meta(ref.critic_shapes())
    adam_d = ref.Adam(5e-5, 0.5, 0.999, 10000)
    st = {"src_params": ref.nest(params), "src_bn": bn, "tgt_bn": bn,
          "dam": {k: v for k, v in params.items() if k[0] in dam_names},
          "critic": critic, "adam_d": adam_d, "opt_d": adam_d.init(critic)}
    x = _images(batch, size)
    # the critic's throttle gates an update, not a product
    return count(lambda: ref_train.adapt_grads(
        st, x, x, {"plug_depth": plug_depth, "d_acc_cap": 1.0}))


@functools.lru_cache(maxsize=None)
def serve_forward(batch: int, size: int, dtype_name: str) -> int:
    """FLOPs of one serving forward of ``batch`` slices."""
    params, bn = _meta_segmenter()
    dtype = getattr(torch, dtype_name)
    return count(lambda: ref.serve_forward(ref.nest(params), bn,
                                           _images(batch, size),
                                           dtype=dtype))
