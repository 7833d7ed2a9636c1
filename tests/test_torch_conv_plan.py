"""The conv kernels' host side on the CPU: the Hopper loop's weight
pre-split (``kernels/conv_tile.py: split_weights_reference``, the plain
version of ``csrc/conv_tile.cuh: split_weights_kernel``) and the tile plan
(``conv_tile.plan``, the mirror of ``conv_tile::plan``) at every call site
of ``configs/mri2ct.json``.

The card's tests hold the pre-pass kernel and the library's plan to these
(``test_torch_kernel_gpu.py``).  Seconds.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from mcmda_tpu_torch import config as config_mod
from mcmda_tpu_torch.kernels import conv_tile

LOW13 = np.uint32(0x1FFF)
# |w - hi - lo| <= 2^-21 |w| (csrc/conv_tile.cuh, split_tf32)
SPLIT_BOUND = 2.0 ** -21


def _weights(seed, c=40, k=24):
    """Seeded HWIO weights over many binades, with exact ties of the TF32
    rounding (low 13 bits 0x1000) of both signs and a few zeros."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(3, 3, c, k)) * 10.0 ** rng.uniform(
        -6, 3, size=(3, 3, c, k))).astype(np.float32)
    bits = w.reshape(-1).view(np.uint32)
    bits[::7] = (bits[::7] & ~LOW13) | np.uint32(0x1000)  # ties
    w.reshape(-1)[::11] = 0.0
    return w


def _rna_numpy(v):
    """cvt.rna.tf32.f32 from the two TF32 neighbours of each value: the
    nearer of the value truncated to 10 significand bits and the next TF32
    value away from zero; a tie goes away from zero."""
    v = np.asarray(v, np.float32)
    down = (v.view(np.uint32) & ~LOW13).view(np.float32)
    up = (down.view(np.uint32) + np.uint32(0x2000)).view(np.float32)
    d_down = np.abs(v.astype(np.float64) - down.astype(np.float64))
    d_up = np.abs(up.astype(np.float64) - v.astype(np.float64))
    return np.where(d_up <= d_down, up, down)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_weights_reference(seed):
    w = _weights(seed)
    c, k = w.shape[2], w.shape[3]
    hi, lo = conv_tile.split_weights_reference(torch.from_numpy(w))
    assert hi.shape == lo.shape == (k, 9 * c)
    assert hi.dtype == lo.dtype == torch.float32
    hi, lo = hi.numpy(), lo.numpy()
    # both halves are TF32: the low 13 bits are zero
    assert not (hi.view(np.uint32) & LOW13).any()
    assert not (lo.view(np.uint32) & LOW13).any()
    # K-major: row kk of the split is column kk of w seen as [9C, K]
    wt = w.reshape(9 * c, k).T
    np.testing.assert_array_equal(hi, _rna_numpy(wt))
    err = np.abs(wt.astype(np.float64) - hi - lo.astype(np.float64))
    assert (err <= SPLIT_BOUND * np.abs(wt.astype(np.float64))).all()
    # the ties went away from zero
    ties = (wt.view(np.uint32) & LOW13) == 0x1000
    assert ties.sum() > 100
    assert (np.abs(hi[ties]) > np.abs(wt[ties])).all()


def test_split_weights_on_the_cpu_is_the_reference():
    w = torch.from_numpy(_weights(3, 8, 64))
    before = conv_tile.LAUNCHES
    got = conv_tile.split_weights(w)
    want = conv_tile.split_weights_reference(w)
    assert conv_tile.LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _sites():
    """(what, (n, h, w, c), k, x dtype) of every conv kernel call of the
    shipped mri2ct config: the fused conv's at batch 8 and 16 under the
    serving (eval) config, whose compute dtype is bf16, and the conv +
    moments kernel's 15 per f32 train forward."""
    path = os.path.join(os.path.dirname(chip_smoke.__file__), "configs",
                        "mri2ct.json")
    serve = config_mod.eval_view(config_mod.load_config(path))
    train = config_mod.load_config(path)
    sites = []
    for n in (8, 16):
        for name, xs, k, _, x_dt, _ in chip_smoke.call_sites(
                serve.segmenter, n, 256):
            sites.append((f"fused {name}", xs, k, getattr(torch, x_dt)))
        sites += [(f"conv_stats {xs}", xs, k, torch.float32)
                  for xs, k, _ in chip_smoke.train_call_sites(
                      train.segmenter, n, 256)]
    return sites


SITES = _sites()


def test_sites_cover_both_dtypes_and_batches():
    assert len(SITES) == 2 * (19 + 15)
    assert {s[3] for s in SITES} == {torch.float32, torch.bfloat16}


@pytest.mark.parametrize("what,xs,k,x_dtype", SITES,
                         ids=[f"{s[0]}-n{s[1][0]}" for s in SITES])
def test_plan_at_every_call_site(what, xs, k, x_dtype):
    n, h, w, c = xs
    p = conv_tile.plan(n, h, w, c, k, x_dtype)
    tail = h == w == 32 and c % 32 == 0 and k % 64 == 0
    stem_or_bf16 = c == 3 or x_dtype == torch.bfloat16 or k <= 32
    if stem_or_bf16:
        assert p.loop == "mma_sync", (what, p)
        assert p.box is None
        assert p.grid == (-(-n * h * w // 128), -(-k // p.bn))
        return
    # every f32 site from rm2 on takes the Hopper loop; the tail does
    assert p.loop == "wgmma", (what, p)
    assert tail or (h, c, k) in {(64, 64, 64), (32, 128, 128)}
    assert p.bn in (64, 128) and k % p.bn == 0
    assert p.grid == (n * h * w // 128, k // p.bn)
    box_h, box_w = p.box
    assert box_h * box_w == 128 and box_w == w and h % box_h == 0
    maps = conv_tile.tensor_maps(n, h, w, c, k, p)
    for name, (dims, strides, box) in maps.items():
        assert len(dims) == len(box) == len(strides) + 1, name
        # TMA: each box side at most 256, the inner box side 128 bytes
        # (the 128-byte swizzle's row), global strides multiples of 16 B
        assert all(1 <= b <= 256 for b in box), (name, box)
        assert box[0] * 4 == 128, (name, box)
        assert all(s % 16 == 0 for s in strides), (name, strides)
        assert all(b <= d for b, d in zip(box, dims)), (name, box, dims)
    assert maps["x"][0] == (c, w, h, n)
    assert maps["w_hi"][0] == (9 * c, k) and maps["w_hi"][2][1] == p.bn


@pytest.mark.parametrize("n,h,w,c,k,x_dtype,loop", [
    (3, 17, 19, 128, 256, torch.float32, "mma_sync"),  # ragged tiles
    (8, 32, 32, 40, 64, torch.float32, "mma_sync"),  # C % 32 != 0
    (8, 32, 32, 128, 96, torch.float32, "mma_sync"),  # K % 64 != 0
    (8, 32, 32, 128, 128, torch.bfloat16, "mma_sync"),  # bf16 x
    (2, 8, 256, 32, 64, torch.float32, "wgmma"),  # half a row per tile
    (1, 2, 64, 32, 64, torch.float32, "wgmma"),  # two rows per tile
    (1, 3, 64, 32, 64, torch.float32, "mma_sync"),  # odd rows: ragged
])
def test_plan_takes_only_whole_row_tiles(n, h, w, c, k, x_dtype, loop):
    p = conv_tile.plan(n, h, w, c, k, x_dtype)
    assert p.loop == loop
    if loop == "wgmma":
        assert p.box[0] * p.box[1] == 128


def test_plan_width_fills_the_card():
    # batch 8: 64 pixel tiles; 128 wide would leave half the SMs idle at
    # K = 128, so 64 wide; batch 16 fills them at 128 wide
    assert conv_tile.plan(8, 32, 32, 128, 128).bn == 64
    assert conv_tile.plan(16, 32, 32, 128, 128).bn == 128
    assert conv_tile.plan(8, 32, 32, 256, 512).bn == 128
    assert conv_tile.plan(8, 32, 32, 256, 512, sms=1000).bn == 64
