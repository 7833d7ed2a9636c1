"""The CUDA kernel against its plain PyTorch version, on the card.

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed.  Every test needs a GPU (``cuda`` marker) and
skips without one.  On a GPU machine without jax::

    python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q

Tolerance rtol = atol = 1e-4: both sides are f32 with TF32 off and differ
only in the order of the summed products.
"""

import numpy as np
import pytest
import torch

from mcmda_tpu_torch.config import SegmenterConfig, StageSpec
from mcmda_tpu_torch.kernels import fused_conv as fk
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
