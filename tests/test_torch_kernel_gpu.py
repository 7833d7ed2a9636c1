"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed.  Every test needs a GPU (``cuda`` marker) and
skips without one.  On a GPU machine without jax::

    python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q

Tolerances: the convs rtol = atol = 1e-4 (both sides f32 with TF32 off;
only the order of the summed products differs); the warp atol 1e-5 (its
sampling coordinates are bitwise the plain version's; only the f32 blend
rounds differently).
"""

import numpy as np
import pytest
import torch

from mcmda_tpu_torch.config import DataConfig, SegmenterConfig, StageSpec
from mcmda_tpu_torch.data import pipeline
from mcmda_tpu_torch.kernels import fused_conv as fk
from mcmda_tpu_torch.kernels import train_conv as tk
from mcmda_tpu_torch.kernels import warp as wk
from mcmda_tpu_torch.models import segmenter


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py covers the kernel")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
@pytest.mark.parametrize("c,k,dilation", [(128, 256, 2), (512, 512, 4),
                                          (5, 70, 1)])
def test_conv_stats_kernel_matches_plain(cuda_device, c, k, dilation):
    x, w = _inputs(3, 3, 17, 19, c, k, cuda_device)[:2]
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
