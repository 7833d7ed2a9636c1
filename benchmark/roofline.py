"""Peaks of the card and the least time of the two conv ops' work.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (no sparsity), at the
full 700 W power limit; the run prints the card's limit beside them.

A conv op's least time is, per call site, the larger of its operations
at the tensor-core rate and its bytes at HBM bandwidth, summed over the
sites.  Operations: the valid taps of the 3x3 window, those that read
inside the image (``flops.valid_taps``, the convention of the FLOP count
and of ``serve_mfu``), 2 FLOPs per multiply-add, times the products a
multiply-add takes at the precision the op keeps: a float32 operand split
into TF32 hi + lo takes 3 products (hi*hi, hi*lo, lo*hi), a bf16 input
against split weights 2.  The zero taps that SAME padding adds are no
work: today's kernels compute them (``every_tap``, the kernel table's
bounds), and a kernel that skips them is held to the same least time.
Bytes: each input read once and each output written once.
"""

from __future__ import annotations

import dataclasses

from benchmark.flops import valid_taps
from benchmark.reference import pnp_adanet as ref

PEAKS = {
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}


@dataclasses.dataclass(frozen=True)
class Site:
    """One call of a conv op: x [n, h, w, cin] -> [n, h, w, cout], 3x3
    with ``dilation``; ``x_bytes`` per input element; ``products`` per
    multiply-add; ``extra_out`` further output arrays of [n, h, w, cout]
    read or written (a residual), ``moments`` per-channel sums out."""

    name: str
    n: int
    h: int
    w: int
    cin: int
    cout: int
    dilation: int
    x_bytes: int
    products: int
    extra_out: int = 0
    moments: bool = False

    @property
    def macs(self) -> int:
        """Multiply-adds of the valid taps (SAME padding, 3x3)."""
        d = self.dilation
        return (self.n * self.cin * self.cout * valid_taps(self.h, self.h, 3,
                                                          1, d, d)
                * valid_taps(self.w, self.w, 3, 1, d, d))

    @property
    def every_tap_macs(self) -> int:
        """Multiply-adds of every tap, the padding's zeros too."""
        return self.n * self.h * self.w * 9 * self.cin * self.cout

    def ops_seconds(self, every_tap: bool = False) -> float:
        macs = self.every_tap_macs if every_tap else self.macs
        return 2 * macs * self.products / PEAKS["tf32_flops"]

    def bytes(self) -> int:
        pix = self.n * self.h * self.w
        b = pix * self.cin * self.x_bytes + 9 * self.cin * self.cout * 4
        b += pix * self.cout * 4 * (1 + self.extra_out)
        if self.moments:
            b += 2 * self.cout * 4
        return b

    def bound_seconds(self) -> float:
        return max(self.ops_seconds(),
                   self.bytes() / PEAKS["hbm_bytes_per_s"])


def conv_stats_sites(batch: int, size: int, in_channels: int = 3):
    """The train forward's conv + BN-moments sites: the stride-1 3x3
    convs with f32 inputs whose in and out widths are multiples of 128
    (3 in rm3, 4 in each of rm4-rm6)."""
    sites = []
    hw, cin = size, in_channels
    for name, feat, stride, dilation, blocks in ref.STAGES:
        hw //= stride
        if name == "stem":
            cin = feat
            continue
        c = cin
        for i in range(blocks):
            for conv, ci in (("conv1", c), ("conv2", feat)):
                if conv == "conv1" and i == 0 and stride != 1:
                    continue
                if ci % 128 == 0 and feat % 128 == 0:
                    sites.append(Site(f"{name}.b{i}.{conv}", batch, hw, hw,
                                      ci, feat, dilation, 4, 3,
                                      moments=True))
            c = feat
        cin = feat
    return sites


def conv_bn_act_sites(batch: int, size: int, bf16: bool,
                      in_channels: int = 3):
    """The serving forward's fused conv + BN + ReLU sites: the stem and
    both convs of every stride-1 block (19).  The first conv after a
    strided block reads that block's output, bf16 when serving in bf16:
    2 products there; every other site reads f32: 3.  A second conv adds
    the residual."""
    sites = [Site("stem", batch, size, size, in_channels, 16, 1, 4, 3)]
    hw, cin = size, 16
    for name, feat, stride, dilation, blocks in ref.STAGES[1:]:
        hw //= stride
        c = cin
        for i in range(blocks):
            if i == 0 and stride != 1:
                c = feat
                continue
            after_strided = i == 1 and stride != 1
            xb = 2 if (bf16 and after_strided) else 4
            sites.append(Site(f"{name}.b{i}.conv1", batch, hw, hw, c, feat,
                              dilation, xb, 2 if xb == 2 else 3))
            sites.append(Site(f"{name}.b{i}.conv2", batch, hw, hw, feat,
                              feat, dilation, 4, 3, extra_out=1))
            c = feat
        cin = feat
    return sites


def ops_seconds(sites, every_tap: bool = False) -> float:
    return sum(s.ops_seconds(every_tap) for s in sites)


def bound_seconds(sites) -> float:
    return sum(s.bound_seconds() for s in sites)
