"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed.  Every test needs a GPU (``cuda`` marker) and
skips without one.  On a GPU machine without jax::

    python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q

Tolerances: the convs rtol = atol = 1e-4 (the plain side f32 with TF32
off, the kernels split TF32, which keeps f32-class accuracy: their error
against an f64 conv is held to 4x the plain f32 conv's); the warp's image
channels bitwise (``torch.equal``: its sampling coordinates and its blend
round as the plain version's tensor operations do) and its renormalised
label channels atol 1e-5 (the label sum's order may differ); the thin
stem's gradients within 1e-4 of the largest.  The CUDA graphs (train
steps, the fed host-sampler step, the one-graph volume, the probe) are
held bitwise (``torch.equal``, ``np.array_equal``) to their eager runs:
the same kernels in the same order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mcmda_tpu_torch.config import DataConfig, SegmenterConfig, StageSpec
from mcmda_tpu_torch.data import pipeline
from mcmda_tpu_torch.kernels import fused_conv as fk
from mcmda_tpu_torch.kernels import thin_conv as sk
from mcmda_tpu_torch.kernels import train_conv as tk
from mcmda_tpu_torch.kernels import warp as wk
from mcmda_tpu_torch.models import segmenter
from mcmda_tpu_torch.utils import device as device_mod


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py covers the kernel")
    return device_mod.resolve("cuda")


def _inputs(seed, n, h, w, c, k, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(n, h, w, c)),
              rng.normal(size=(3, 3, c, k)) * np.sqrt(2.0 / (9 * c)),
              rng.uniform(0.5, 1.5, size=k), rng.normal(size=k),
              rng.normal(size=(n, h, w, k)))
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,dilation,dtype,activation", [
    (3, 16, 1, torch.float32, "relu"),
    (32, 32, 1, torch.bfloat16, "relu"),
    (128, 256, 2, torch.float32, "leaky_relu"),
    (5, 70, 4, torch.float32, "none")])
def test_kernel_matches_plain(cuda_device, c, k, dilation, dtype,
                              activation):
    x, w, s, b, r = _inputs(9, 3, 17, 19, c, k, cuda_device)
    x, r = x.to(dtype), r.to(dtype)
    kw = dict(dilation=dilation, activation=activation, residual=r)
    before = fk.LAUNCHES
    got = fk.conv_bn_act(x, w, s, b, **kw)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == before + 1
    assert got.dtype == torch.float32
    want = fk.conv_bn_act_reference(x, w, s, b, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# The split-TF32 tiles' edges: M = 3*17*19 = 969 is not a multiple of the
# 128-pixel tile; C = 40 / 48 are not multiples of the 32-deep step; C = 3
# and 5 take the narrow (flattened-reduction) gather, K = 70 the narrow
# weight loads; K = 16 / 32 / 64 / 70 pick each channel-width tile.
@pytest.mark.cuda
@pytest.mark.parametrize("c,k", [(3, 16), (40, 32), (48, 64), (40, 70),
                                 (5, 16)])
def test_kernel_tile_edges_match_plain(cuda_device, c, k):
    x, w, s, b, r = _inputs(13, 3, 17, 19, c, k, cuda_device)
    kw = dict(dilation=2, activation="relu", residual=r)
    got = fk.conv_bn_act(x, w, s, b, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fk.conv_bn_act_reference(x, w, s, b, **kw),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("x_dtype,r_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, None)])
def test_kernel_dtype_pairs_match_plain(cuda_device, x_dtype, r_dtype,
                                        dilation):
    # C = 48: 16-byte chunks for both x dtypes, and a ragged second step
    x, w, s, b, r = _inputs(14, 2, 20, 21, 48, 64, cuda_device)
    x = x.to(x_dtype)
    r = None if r_dtype is None else r.to(r_dtype)
    kw = dict(dilation=dilation, activation="leaky_relu", residual=r)
    got = fk.conv_bn_act(x, w, s, b, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fk.conv_bn_act_reference(x, w, s, b, **kw),
                               rtol=1e-4, atol=1e-4)


def _f64_errors(x, w, dilation, kernel):
    """Max |kernel - f64 conv| and max |plain f32 - f64 conv|."""
    from mcmda_tpu_torch.ops import layers

    exact = layers.conv_apply({"w": w}, x, dilation=dilation,
                              compute_dtype=torch.float64)
    plain = layers.conv_apply({"w": w}, x, dilation=dilation)
    got = kernel(x, w, dilation)
    torch.cuda.synchronize()
    return ((got.double() - exact).abs().max().item(),
            (plain.double() - exact).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("n,hw,c,k,dilation", [(8, 32, 512, 512, 4),
                                               (8, 256, 3, 16, 1)])
def test_split_tf32_f64_control(cuda_device, n, hw, c, k, dilation):
    """Split TF32 keeps f32-class accuracy: both kernels' error against an
    f64 conv is at most 4x the plain f32 conv's (TF32 off)."""
    x, w = _inputs(15, n, hw, hw, c, k, cuda_device)[:2]
    one = torch.ones(k, device=cuda_device)
    zero = torch.zeros(k, device=cuda_device)
    for kernel in (
            lambda a, b, d: fk.conv_bn_act(a, b, one, zero, dilation=d,
                                           activation="none"),
            lambda a, b, d: tk.conv_stats_forward(a, b, d)[0]):
        err, plain_err = _f64_errors(x, w, dilation, kernel)
        assert err <= 4 * plain_err, (err, plain_err)


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda_device):
    x, w, s, b, r = _inputs(1, 1, 8, 8, 4, 8, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fk.conv_bn_act(x.transpose(1, 2), w, s, b)
    with pytest.raises(TypeError, match="dtype"):
        fk.conv_bn_act(x.half(), w, s, b)
    with pytest.raises(ValueError, match="is on cpu"):
        fk.conv_bn_act(x, w.cpu(), s, b)
    with pytest.raises(ValueError, match="shape"):
        fk.conv_bn_act(x, w, s, b, residual=r[..., :4])


@pytest.mark.cuda
def test_fused_forward_matches_plain(cuda_device):
    """The whole fused forward through the kernel against the same forward
    on the plain version: one launch per fused call site."""
    cfg = SegmenterConfig(stages=(
        StageSpec("stem", 8, 1, 1, 1), StageSpec("rm1", 16, 2, 1, 2),
        StageSpec("rm2", 24, 2, 2, 2)))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params, state = segmenter.init(cfg, generator=gen, device=cuda_device)
    x = torch.randn((2, 32, 32, 3), generator=gen, device=cuda_device)
    before = fk.LAUNCHES
    got, _ = segmenter.apply_fused_eval(params, state, x, cfg)
    torch.cuda.synchronize()
    # stem + rm1.b1 (2) + rm2.b1 (2)
    assert fk.LAUNCHES == before + 5
    want, _ = segmenter.apply_fused_eval(params, state, x, cfg,
                                         use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,k,dilation", [
    (3, 17, 19, 128, 256, 2), (3, 17, 19, 512, 512, 4), (3, 17, 19, 5, 70, 1),
    (3, 17, 19, 40, 16, 1), (3, 17, 19, 48, 32, 2), (3, 17, 19, 128, 64, 4),
    # the train path's 128 -> 128 (64-wide tiles) and 512 -> 512 (128-wide
    # tiles) at its 8 x 32 x 32 pixels
    (8, 32, 32, 128, 128, 1), (8, 32, 32, 512, 512, 4)])
def test_conv_stats_kernel_matches_plain(cuda_device, n, h, w, c, k,
                                         dilation):
    x, w = _inputs(3, n, h, w, c, k, cuda_device)[:2]
    before = tk.LAUNCHES
    z, s, ss = tk.conv_stats_forward(x, w, dilation)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    rz, rs, rss = tk.conv_stats_reference(x, w, dilation)
    torch.testing.assert_close(z, rz, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, rs, rtol=0,
                               atol=1e-4 * rz.abs().sum().item() / k)
    torch.testing.assert_close(ss, rss, rtol=1e-4, atol=0)
    # bitwise repeatable: no atomics
    z2, s2, ss2 = tk.conv_stats_forward(x, w, dilation)
    assert torch.equal(z, z2) and torch.equal(s, s2) and torch.equal(ss, ss2)


@pytest.mark.cuda
def test_conv_stats_gradients_match_plain_autograd(cuda_device):
    x, w = _inputs(4, 2, 9, 9, 128, 128, cuda_device)[:2]
    grads = []
    for fn in (tk.conv_stats, tk.conv_stats_reference):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        z, s, ss = fn(xg, wg, 2)
        f = torch.tanh(z).sum() + torch.square(s).sum() * 1e-3 \
            + torch.sqrt(ss).sum()
        grads.append(torch.autograd.grad(f, (xg, wg)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("n_image", [3, 8])
def test_warp_kernel_matches_plain(cuda_device, n_image):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    draws = pipeline.draw_params(gen, DataConfig(), 4, cuda_device)
    draws[:, 0] = torch.tensor([0.0, 1.0, 0.0, 1.0])
    coefs = wk.affine_coefs(*draws[:, 1:].unbind(-1), draws[:, 0], 64, 48)
    x = torch.rand((4, 64, 48, 8), device=cuda_device, generator=gen)
    before = wk.LAUNCHES
    got = wk.warp_affine(x, coefs, n_image=n_image)
    torch.cuda.synchronize()
    assert wk.LAUNCHES == before + 1
    want = wk.warp_affine_reference(x, coefs, n_image=n_image)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _warp_case(device, b, h, w, c, seed, shift=None):
    """Seeded packed batch and coefficients over the shipped ranges: flips
    alternate, the last image is the identity transform; ``shift`` (pixels)
    overrides the drawn shifts."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = pipeline.draw_params(gen, DataConfig(), b, device)
    draws[:, 0] = (torch.arange(b, device=device) % 2).float()
    if shift is not None:
        draws[:, 3:] = shift
    draws[-1] = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0])
    coefs = wk.affine_coefs(*draws[:, 1:].unbind(-1), draws[:, 0], h, w)
    # signed values everywhere would put the label sum near 0, where the
    # division amplifies its last bits: callers renormalise x[..., n_image:]
    x = torch.randn((b, h, w, c), device=device, generator=gen)
    return x, coefs


# (8, 3) takes the float4 kernel, (3, 3) the staged-store kernel (at widths
# with and without whole float4 rows), the others the generic kernel; the
# sizes leave ragged tiles on both axes
@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,n_image", [
    (64, 48, 8, 3), (37, 41, 8, 3), (64, 48, 3, 3), (37, 44, 3, 3),
    (37, 41, 3, 3), (37, 41, 5, 2), (20, 24, 8, 8), (20, 24, 4, 0)])
@pytest.mark.parametrize("shift", [None, 30.0])
def test_warp_image_channels_bitwise_equal_plain(cuda_device, h, w, c,
                                                 n_image, shift):
    """Flips, rotation, zoom, the identity row and (shift 30) images pushed
    so far that whole rows fall outside: the image channels equal the plain
    version's bit for bit, the labels within 1e-5, and a second call on
    the same inputs gives the same bits."""
    x, coefs = _warp_case(cuda_device, 4, h, w, c, 21, shift)
    x[..., n_image:] = x[..., n_image:].abs()  # labels are non-negative
    got = wk.warp_affine(x, coefs, n_image=n_image)
    torch.cuda.synchronize()
    want = wk.warp_affine_reference(x, coefs, n_image=n_image)
    assert torch.equal(got[..., :n_image], want[..., :n_image])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got, wk.warp_affine(x, coefs, n_image=n_image))
    if shift is None and n_image == c:
        assert torch.equal(got[-1], x[-1])  # the identity row
    if shift is not None:
        zero = (want == 0).all(-1)
        assert zero.float().mean() > 0.1
        assert (got[zero] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 3])
def test_warp_unaligned_tensor_takes_the_scalar_kernels(cuda_device, c):
    """A contiguous tensor 4 bytes off a 16-byte boundary cannot take
    float4 accesses: the entry point sends it to the kernels' scalar paths,
    with the same bits."""
    x, coefs = _warp_case(cuda_device, 2, 32, 32, c, 22)
    x[..., 3:] = x[..., 3:].abs()  # labels are non-negative
    flat = torch.empty(x.numel() + 1, device=cuda_device)
    off = flat[1:].view(x.shape)
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    want = wk.warp_affine(x, coefs, n_image=3)
    assert torch.equal(wk.warp_affine(off, coefs, n_image=3)[..., :3],
                       want[..., :3])
    torch.testing.assert_close(wk.warp_affine(off, coefs, n_image=3), want,
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_train_wrappers_raise_instead_of_falling_back(cuda_device):
    x, w = _inputs(5, 1, 8, 8, 4, 8, cuda_device)[:2]
    with pytest.raises(TypeError, match="dtype"):
        tk.conv_stats_forward(x.double(), w, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tk.conv_stats_forward(x.transpose(1, 2), w, 1)
    with pytest.raises(ValueError, match="is on cpu"):
        tk.conv_stats_forward(x, w.cpu(), 1)
    img = torch.zeros((2, 8, 8, 3), device=cuda_device)
    coefs = torch.zeros((2, 6), device=cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        wk.warp_affine(img.half(), coefs)
    with pytest.raises(ValueError, match="shape"):
        wk.warp_affine(img, coefs[:1])
    with pytest.raises(ValueError, match="n_image"):
        wk.warp_affine(img, coefs, n_image=4)
    with pytest.raises(ValueError, match="contiguous"):
        wk.warp_affine(img.transpose(1, 2), coefs)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,k", [
    (2, 32, 32, 3, 16), (3, 17, 19, 3, 8), (1, 9, 40, 5, 32),
    # four pixels per thread: widths with a ragged last thread (W % 4 != 0)
    # and ragged blocks, each K, the thinnest and the widest C
    (2, 37, 41, 3, 16), (2, 37, 44, 3, 32), (1, 12, 260, 3, 8),
    (2, 19, 23, 1, 16), (1, 10, 36, 16, 32), (1, 11, 13, 16, 8)])
def test_thin_conv_kernel_matches_plain(cuda_device, n, h, w, c, k):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(
        np.float32)).to(cuda_device)
    wt = torch.from_numpy((0.2 * rng.normal(size=(3, 3, c, k))).astype(
        np.float32)).to(cuda_device)
    before = sk.LAUNCHES
    got = sk.stem_conv_forward(x, wt)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 1
    assert got.shape == (n, k, h, w) and got.is_contiguous()
    torch.testing.assert_close(got, sk.stem_conv_nhwc_reference(x, wt),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_thin_conv_two_streams_are_independent(cuda_device):
    """Launches on two streams with different weights share no state (the
    weights are loaded by each block, not copied into one bank per
    library): every result is its own plain version's."""
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.normal(size=(8, 128, 128, 3)).astype(
        np.float32)).to(cuda_device)
    ws = [torch.from_numpy((s * rng.normal(size=(3, 3, 3, 16))).astype(
        np.float32)).to(cuda_device) for s in (0.2, 1.0)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(8):
        for st, w in zip(streams, ws):
            with torch.cuda.stream(st):
                outs.append((w, sk.stem_conv_forward(x, w)))
    torch.cuda.synchronize()
    for w, got in outs:
        torch.testing.assert_close(got, sk.stem_conv_nhwc_reference(x, w),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_thin_conv_unaligned_x_takes_the_scalar_loads(cuda_device):
    """x 4 bytes off a 16-byte boundary: no staged float4 loads, the same
    bits."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(size=(2, 16, 32, 3)).astype(
        np.float32)).to(cuda_device)
    w = torch.from_numpy((0.2 * rng.normal(size=(3, 3, 3, 16))).astype(
        np.float32)).to(cuda_device)
    off = torch.empty(x.numel() + 1, device=cuda_device)[1:].view(x.shape)
    off.copy_(x)
    assert off.data_ptr() % 16 == 4
    want = sk.stem_conv_forward(x, w)
    assert torch.equal(sk.stem_conv_forward(off, w), want)


@pytest.mark.cuda
@pytest.mark.parametrize("input_grad", [False, True])
def test_thin_conv_stem_gradients_match_plain(cuda_device, input_grad):
    """stem_apply_cf in train mode through the kernel's StemConv against
    the plain conv under autograd: output, dw, and dx (None by default)."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(
        np.float32)).to(cuda_device)
    p = {"conv": {"w": torch.from_numpy((0.2 * rng.normal(
        size=(3, 3, 3, 16))).astype(np.float32)).to(cuda_device)},
         "bn": {"scale": torch.ones(16, device=cuda_device),
                "bias": torch.zeros(16, device=cuda_device)}}
    st = {"bn": {"mean": torch.zeros(16, device=cuda_device),
                 "var": torch.ones(16, device=cuda_device)}}
    r = torch.from_numpy(rng.normal(size=(2, 32, 32, 16)).astype(
        np.float32)).to(cuda_device)
    out = []
    for use_kernel in (True, False):
        xg = x.clone().requires_grad_()
        wg = p["conv"]["w"].clone().requires_grad_()
        h, _ = sk.stem_apply_cf({"conv": {"w": wg}, "bn": p["bn"]}, st, xg,
                                train=True, momentum=0.99, eps=1e-5,
                                use_kernel=use_kernel, input_grad=input_grad)
        dx, dw = torch.autograd.grad((h * r).sum(), (xg, wg),
                                     allow_unused=True)
        out.append((h, dx, dw))
    (h, dx, dw), (rh, rdx, rdw) = out
    torch.testing.assert_close(h, rh, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dw, rdw, rtol=1e-4,
                               atol=1e-4 * rdw.abs().max().item())
    if input_grad:
        torch.testing.assert_close(dx, rdx, rtol=1e-4,
                                   atol=1e-4 * rdx.abs().max().item())
    else:
        assert dx is None


@pytest.mark.cuda
def test_thin_conv_wrapper_raises_instead_of_falling_back(cuda_device):
    x = torch.zeros((1, 8, 8, 3), device=cuda_device)
    w = torch.zeros((3, 3, 3, 16), device=cuda_device)
    with pytest.raises(ValueError, match="K in"):
        sk.stem_conv_forward(x, torch.zeros((3, 3, 3, 12),
                                            device=cuda_device))
    with pytest.raises(TypeError, match="dtype"):
        sk.stem_conv_forward(x.double(), w)
    with pytest.raises(ValueError, match="contiguous"):
        sk.stem_conv_forward(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="is on cpu"):
        sk.stem_conv_forward(x, w.cpu())


# ------------------------------------------------ the host feed and the pins
@pytest.mark.cuda
def test_prefetched_feed_equals_synchronous_feed(cuda_device):
    """20 batches through ``prefetch_to_device`` (pinned staging ring, side
    stream) on a consumer that runs on a stream of its own, against a
    blocking copy of the same batches: bitwise equal after device work that
    keeps each batch in use while later copies are in flight."""
    def stream():
        rng = np.random.default_rng(4)
        for _ in range(20):
            yield {"image": rng.normal(size=(8, 256, 256, 3)),  # f64 in
                   "label": rng.random((8, 256, 256, 5), np.float32)}

    def work(b):
        acc = b["image"]
        for _ in range(20):  # outlives the host's next put
            acc = acc * 1.0001 + 0.5
        return acc.sum((1, 2)), b["label"].mean((1, 2))

    consumer = torch.cuda.Stream()
    got = []
    with torch.cuda.stream(consumer):
        for b in pipeline.prefetch_to_device(stream(), size=2,
                                             device=cuda_device):
            assert b["image"].is_cuda and b["image"].dtype == torch.float32
            got.append(work(b))
            del b
    torch.cuda.synchronize()
    want = [work({k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                  .to(cuda_device) for k, v in b.items()})
            for b in stream()]
    torch.cuda.synchronize()
    assert len(got) == len(want) == 20
    for (gi, gl), (wi, wl) in zip(got, want):
        assert torch.equal(gi, wi) and torch.equal(gl, wl)


@pytest.mark.cuda
def test_device_helper_pins_tf32_off_and_deterministic_cudnn():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.deterministic = False
        assert device_mod.settings() == {"tf32": True,
                                         "cudnn_deterministic": False}
        assert device_mod.resolve("cuda") == torch.device("cuda")
        assert device_mod.settings() == {"tf32": False,
                                         "cudnn_deterministic": False}
        device_mod.resolve("cuda:0", deterministic=True)
        assert device_mod.settings() == {"tf32": False,
                                         "cudnn_deterministic": True}
        # f32 means f32: a matmul agrees with its f64 value to f32 rounding
        a = torch.randn(512, 512, device="cuda")
        err = ((a @ a).double() - a.double() @ a.double()).abs().max()
        assert err.item() < 1e-3
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def _tiny_train_config(**adapt_kw):
    """The CPU tests' tiny config (32x32 slices, thin stages) with the
    warp and conv + moments kernels asked for; rm4 and rm5 are 128 wide,
    so that 3 stride-1 convs per forward take the conv + moments kernel
    (it needs both widths to be multiples of 128)."""
    from mcmda_tpu_torch import config as tcfg
    stages = (StageSpec("stem", 8, 1, 1, 1), StageSpec("rm1", 8, 2, 1, 1),
              StageSpec("rm2", 16, 2, 1, 1), StageSpec("rm3", 16, 2, 1, 1),
              StageSpec("rm4", 128, 1, 2, 1), StageSpec("rm5", 128, 1, 2, 1))
    return tcfg.ExperimentConfig(
        segmenter=SegmenterConfig(stages=stages, train_fused="pallas"),
        critic=tcfg.CriticConfig(taps=("rm4", "rm5"), compress_features=8,
                                 widths=(8, 16), strides=(2, 1)),
        data=DataConfig(slice_size=32, batch_size=4, shift_pixels=2.0,
                        warp="pallas"),
        source=tcfg.SourceTrainConfig(lr=1e-3, steps=20),
        adapt=tcfg.AdaptConfig(plug_depth="rm2", steps=10, lr_d=1e-3,
                               lr_g=1e-3, **adapt_kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["t1", "adapt", "adapt-ema"])
@pytest.mark.parametrize("donate", [True, False])
def test_graph_steps_equal_eager_steps(cuda_device, case, donate):
    """Two calls of 4 steps on a CUDA graph (the first: one eager step,
    the capture, 3 replays) against the eager path with the same seeds:
    every state tensor and the last metrics ``torch.equal`` (the same
    kernels in the same order, deterministic cuDNN); the wrappers count
    the warm-up step and the capture, a quarter of the 8 eager steps'
    launches each, and no replay; without donation the first call's state
    survives the second."""
    from mcmda_tpu_torch.data import synthetic, volumes
    from mcmda_tpu_torch.train import adapt, loop, source
    from mcmda_tpu_torch.utils import tree

    saved = torch.backends.cudnn.deterministic
    device_mod.resolve("cuda", deterministic=True)
    try:
        cfg = _tiny_train_config(
            **({"dam_ema": 0.5, "d_acc_cap": 0.5} if case == "adapt-ema"
               else {}))
        mri_v, mri_l = synthetic.make_dataset(0, "mri", 1, 8, 32)
        ct_v, _ = synthetic.make_dataset(0, "ct", 1, 8, 32)
        src = volumes.volumes_to_slices(mri_v, mri_l, context=3,
                                        drop_empty=True)
        s0 = source.init_state(0, cfg, cuda_device)
        if case == "t1":
            make, state0 = source.make_train_step, s0
            data = pipeline.to_device_arrays(src, 5, cuda_device)
        else:
            make = adapt.make_adapt_step
            state0 = adapt.init_state(2, cfg, s0.params, s0.bn_state)
            data = {"src": pipeline.to_device_arrays(src, device=cuda_device),
                    "tgt": pipeline.to_device_arrays(
                        volumes.volumes_to_slices(ct_v, context=3),
                        device=cuda_device)}

        def run(graph):
            step = loop.scanned_step(make(cfg, sample_from_device=True), 4,
                                     graph=graph, donate=donate)
            wk.LAUNCHES = tk.LAUNCHES = 0
            s1, m1 = step(state0, data, 11)
            first = [t.clone() for t in tree.leaves(s1)]
            kept = tree.leaves(s1)
            s2, m2 = step(s1, data, 12)
            torch.cuda.synchronize()
            return first, kept, s2, m1, m2, (wk.LAUNCHES, tk.LAUNCHES)

        e_first, _, e2, em1, em2, e_n = run(False)
        g_first, g_kept, g2, gm1, gm2, g_n = run(True)
        assert e_n[0] == 8 and e_n[1] > 0
        assert g_n == tuple(2 * n // 8 for n in e_n)
        for a, b in zip(g_first, e_first):
            assert torch.equal(a, b)
        ga, ea = tree.leaves(g2), tree.leaves(e2)
        assert len(ga) == len(ea)
        for a, b in zip(ga, ea):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for gm, em in ((gm1, em1), (gm2, em2)):
            assert set(gm) == set(em)
            for k in gm:
                assert torch.equal(gm[k], em[k]), k
        if not donate:
            for a, b in zip(g_kept, g_first):
                assert torch.equal(a, b)
    finally:
        torch.backends.cudnn.deterministic = saved


# ------------------------------------------ the graphed calls and fed steps
def _tiny_sources(cuda_device):
    from mcmda_tpu_torch.data import synthetic, volumes
    mri_v, mri_l = synthetic.make_dataset(0, "mri", 1, 8, 32)
    ct_v, _ = synthetic.make_dataset(0, "ct", 1, 8, 32)
    return (volumes.volumes_to_slices(mri_v, mri_l, context=3,
                                      drop_empty=True),
            volumes.volumes_to_slices(ct_v, context=3), ct_v[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["t1", "adapt"])
def test_fed_graph_step_equals_eager_step(cuda_device, case):
    """5 host batches through ``prefetch_to_device`` into
    ``drivers.wrap_dp``'s step (a fed CUDA graph on a GPU) against the
    eager step on the same batches and seeds: every state tensor and each
    step's metrics ``torch.equal``; a batch of another shape raises."""
    from mcmda_tpu_torch.train import adapt, drivers, source
    from mcmda_tpu_torch.utils import cuda_graph, tree

    saved = torch.backends.cudnn.deterministic
    device_mod.resolve("cuda", deterministic=True)
    try:
        cfg = _tiny_train_config()
        src, tgt, _ = _tiny_sources(cuda_device)
        s0 = source.init_state(0, cfg, cuda_device)
        if case == "t1":
            make, state0 = source.make_train_step, s0

            def batches():
                return iter(pipeline.BatchSampler(src, 4, seed=1,
                                                  num_classes=5))
        else:
            make = adapt.make_adapt_step
            state0 = adapt.init_state(2, cfg, s0.params, s0.bn_state)

            def batches():
                return ({"src_image": a["image"], "tgt_image": b["image"]}
                        for a, b in zip(pipeline.BatchSampler(src, 4, seed=3),
                                        pipeline.BatchSampler(tgt, 4,
                                                              seed=4)))

        graph = drivers.wrap_dp(cfg, make, device=cuda_device)[0]
        assert isinstance(graph, cuda_graph.GraphedSteps) and graph.fed
        runs = []
        for step in (make(cfg), graph):
            feed = pipeline.prefetch_to_device(batches(), 2, cuda_device)
            st, ms = state0, []
            for i in range(5):
                st, m = step(st, next(feed), 100 + i)
                ms.append({k: v.clone() for k, v in m.items()})
            torch.cuda.synchronize()
            runs.append((tree.leaves(st), ms))
        (e_state, e_ms), (g_state, g_ms) = runs
        assert len(e_state) == len(g_state)
        for a, b in zip(g_state, e_state):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for gm, em in zip(g_ms, e_ms):
            assert set(gm) == set(em)
            for k in gm:
                assert torch.equal(gm[k], em[k]), k
        bad = {k: v[:2].clone() for k, v in next(iter(
            pipeline.prefetch_to_device(batches(), 1, cuda_device))).items()}
        with pytest.raises(ValueError, match="captured for a batch"):
            graph(st, bad, 7)
    finally:
        torch.backends.cudnn.deterministic = saved


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["plain", "fused"])
def test_graphed_predict_volume_equals_batch_loop(cuda_device, path):
    """``predict_volume``'s one-graph volume (the default) against its
    eager batch loop, ``np.array_equal``: plain, flip TTA at a doubled
    batch, and flip TTA with the weights as ``fwd_args`` (copied in per
    call; a second volume replays the cached graph)."""
    from mcmda_tpu_torch.evaluation import inference
    from mcmda_tpu_torch.train import source

    cfg = _tiny_train_config()
    s0 = source.init_state(0, cfg, cuda_device)
    apply = segmenter.apply if path == "plain" else segmenter.apply_fused_eval

    def fwd(x, params, bn):
        return apply(params, bn, x, cfg.segmenter)[1]

    _, _, vol = _tiny_sources(cuda_device)
    vols = [vol[:7], vol[1:8]]  # 7 slices at batch 4: a pad row
    args = (s0.params, s0.bn_state)
    with torch.inference_mode():
        for f, fwd_args in ((lambda x: fwd(x, *args), ()),
                            (inference.tta_flip(lambda x: fwd(x, *args)), ()),
                            (inference.tta_flip(fwd), args)):
            for v in vols:
                got = inference.predict_volume(f, v, batch_size=4,
                                               fwd_args=fwd_args,
                                               device=cuda_device)
                want = inference.predict_volume(f, v, batch_size=4,
                                                single_dispatch=False,
                                                fwd_args=fwd_args,
                                                device=cuda_device)
                assert got.shape == v.shape and np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("use_avg", [False, True])
def test_graphed_probe_equals_eager_probe(cuda_device, use_avg,
                                          monkeypatch):
    """The class-ratio probe on a CUDA graph against the same probe run
    eagerly: fractions and entropy ``torch.equal``, at the first call and
    after the weights change (copied into the graph's own buffers), also
    when a state's dicts hold their keys in another order (each leaf goes
    to its key's buffer)."""
    from mcmda_tpu_torch.train import adapt, drivers, source
    from mcmda_tpu_torch.utils import tree

    cfg = _tiny_train_config(dam_ema=0.5)
    s0 = source.init_state(0, cfg, cuda_device)
    state = adapt.init_state(2, cfg, s0.params, s0.bn_state)
    rng = np.random.default_rng(5)
    state = dataclasses.replace(
        state, ema_w=torch.tensor(0.4, device=cuda_device),
        avg_dam=tree.tree_map(lambda a: a * 0.3, state.dam_params),
        avg_bn=tree.tree_map(lambda a: a * 0.4, state.tgt_bn))
    imgs = rng.normal(size=(9, 32, 32, 3)).astype(np.float32)
    graph = adapt.make_class_ratio_probe(cfg, imgs, use_avg=use_avg)
    monkeypatch.setattr(drivers, "dispatch", lambda *a: "eager")
    eager = adapt.make_class_ratio_probe(cfg, imgs, use_avg=use_avg)
    monkeypatch.undo()
    other = dataclasses.replace(state, dam_params=tree.tree_map(
        lambda a: a * 1.05, state.dam_params))

    def reordered(node):
        if isinstance(node, dict):
            return {k: reordered(node[k]) for k in reversed(list(node))}
        return node * 1.1

    shuffled = dataclasses.replace(other, tgt_bn=reordered(other.tgt_bn))
    for st in (state, other, shuffled, state):
        (gf, ge), (ef, ee) = graph(st), eager(st)
        assert torch.equal(gf, ef) and torch.equal(ge, ee)


@pytest.mark.cuda
def test_graphed_call_capture_with_a_host_sync_raises(cuda_device):
    """A captured function that reads a value on the host raises under
    the capture's sync debug mode: nothing falls back to eager."""
    from mcmda_tpu_torch.utils import cuda_graph

    def synced(x):
        return x * float(x.sum())

    run = cuda_graph.GraphedCall(synced, lambda x: x * 2, cuda_device)
    with pytest.raises(RuntimeError):
        run(torch.ones(8, device=cuda_device))
    plain = cuda_graph.GraphedCall(lambda x: x * 2, lambda x: x * 2,
                                   cuda_device)
    assert torch.equal(plain(torch.ones(8)), torch.full((8,), 2.0,
                                                        device=cuda_device))
    with pytest.raises(ValueError, match="captured for a call"):
        plain(torch.ones(9))
