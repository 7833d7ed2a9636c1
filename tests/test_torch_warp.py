"""The port's augmentation warp against the JAX package, on the CPU.

Both packages get the same images and the same drawn parameters
(``flip, theta, zoom, shift_y, shift_x``): JAX's threefry and torch's
generators never agree, so the draws are injected.  On the CPU the port's
``warp_affine`` runs its plain version.  The JAX side runs its f32 oracle
(``warp_affine_reference``, held at atol 1e-5) and its Pallas kernel in
TPU-interpret mode, whose bf16 MXU payload is held at that kernel's own
tolerance, 0.02 (``tests/test_kernels.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcmda_tpu import config as jcfg
from mcmda_tpu.data import pipeline as jpipe
from mcmda_tpu.kernels import warp as jwarp
from mcmda_tpu_torch import config as tcfg
from mcmda_tpu_torch.data import pipeline
from mcmda_tpu_torch.kernels import warp

SIZE = 32
ATOL = 1e-5
# the flip folded into the coefficients gives the same sampling coordinates
# as flip-then-warp in another operation order: they differ by an ulp of
# the coordinate (~4e-6 at 32 px), which moves a bilinear sample by that
# times the image's local slope (a few units for N(0,1) pixels)
FOLDED_ATOL = 5e-5


def _draws(seed, b=6, shift=10.0):
    """Seeded draws over the shipped ranges (15 deg, zoom 0.9-1.1): flips
    alternate, the last image is the identity transform."""
    rng = np.random.default_rng(seed)
    d = np.stack([np.arange(b) % 2,
                  rng.uniform(-1, 1, b) * np.deg2rad(15.0),
                  rng.uniform(0.9, 1.1, b),
                  rng.uniform(-shift, shift, b),
                  rng.uniform(-shift, shift, b)], -1).astype(np.float32)
    d[-1] = [0, 0, 1, 0, 0]
    return d


def _batch(seed, b=6, ci=3, k=5):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, SIZE, SIZE, ci)).astype(np.float32)
    lab = np.eye(k, dtype=np.float32)[rng.integers(0, k, (b, SIZE, SIZE))]
    return img, lab


def _jax_coefs(d):
    return jax.vmap(lambda t, z, a, b_, f: jwarp.affine_coefs(
        t, z, a, b_, f, SIZE, SIZE))(*(jnp.asarray(d[:, i])
                                       for i in (1, 2, 3, 4, 0)))


def _torch_coefs(d):
    t = torch.from_numpy(d)
    return warp.affine_coefs(t[:, 1], t[:, 2], t[:, 3], t[:, 4], t[:, 0],
                             SIZE, SIZE)


def test_affine_coefs_match_jax():
    d = _draws(0)
    np.testing.assert_allclose(_torch_coefs(d).numpy(),
                               np.asarray(_jax_coefs(d)), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("shift", [10.0, 40.0])
def test_plain_warp_matches_jax_oracle(shift):
    """Flips, rotation, zoom and the identity; with 40-pixel shifts whole
    bands of the output fall outside the input and must be exactly 0."""
    d = _draws(1, shift=shift)
    img, lab = _batch(2)
    packed = np.concatenate([img, lab], -1)
    want = np.asarray(jwarp.warp_affine_reference(jnp.asarray(packed),
                                                  _jax_coefs(d)))
    got = warp.warp_affine(torch.from_numpy(packed), _torch_coefs(d))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(got.numpy()[-1], packed[-1])  # identity
    if shift == 40.0:
        zero = np.all(want == 0, axis=-1)
        assert zero.mean() > 0.1
        assert np.all(got.numpy()[zero] == 0)


def test_plain_warp_matches_pallas_interpret():
    d = _draws(3)
    img, lab = _batch(4)
    packed = np.concatenate([img, lab], -1)
    with pltpu.force_tpu_interpret_mode():
        want = jwarp.warp_affine(jnp.asarray(packed), _jax_coefs(d),
                                 interpret=True)
    got = warp.warp_affine(torch.from_numpy(packed), _torch_coefs(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.02)


def _cfgs(warp_impl):
    jc = jcfg.DataConfig(slice_size=SIZE, batch_size=6, warp=warp_impl)
    tc = tcfg.DataConfig(**dataclasses.asdict(jc))
    return jc, tc


@pytest.mark.parametrize("warp_impl", ["xla", "pallas"])
def test_augment_batch_matches_jax_augment_pair(warp_impl, monkeypatch):
    """The port's augment_batch (flip then warp under "xla", the flip
    folded into the warp's coefficients under "pallas") against the JAX
    package's augment_pair driven by the same draws: image and renormalised
    labels.  Under "pallas" it is also held, at ATOL, to the JAX package's
    own folded-coefficient transform in f32 (its Pallas path's oracle)."""
    d = _draws(5)
    img, lab = _batch(6)
    jc, tc_ = _cfgs(warp_impl)
    want_i, want_l = [], []
    for b in range(d.shape[0]):
        row = d[b]
        monkeypatch.setattr(jpipe, "_draw_params", lambda rng, cfg, r=row: (
            jnp.asarray(r[0] > 0), *(jnp.float32(v) for v in r[1:])))
        wi, wl = jpipe.augment_pair(jax.random.key(0), jnp.asarray(img[b]),
                                    jnp.asarray(lab[b]), jc)
        want_i.append(np.asarray(wi))
        want_l.append(np.asarray(wl))
    gi, gl = pipeline.augment_batch(None, torch.from_numpy(img),
                                    torch.from_numpy(lab), tc_,
                                    draws=torch.from_numpy(d))
    atol = ATOL if warp_impl == "xla" else FOLDED_ATOL
    np.testing.assert_allclose(gi.numpy(), np.stack(want_i), atol=atol)
    np.testing.assert_allclose(gl.numpy(), np.stack(want_l), atol=atol)
    s = gl.numpy().sum(-1)
    assert np.all((np.abs(s - 1) < 1e-5) | (s == 0))
    if warp_impl == "pallas":
        both = np.asarray(jwarp.warp_affine_reference(
            jnp.asarray(np.concatenate([img, lab], -1)), _jax_coefs(d)))
        jl = both[..., 3:] / np.maximum(both[..., 3:].sum(-1, keepdims=True),
                                        1e-6)
        np.testing.assert_allclose(gi.numpy(), both[..., :3], atol=ATOL)
        np.testing.assert_allclose(gl.numpy(), jl, atol=ATOL)


def test_augment_images_matches_augment_batch_image():
    d = torch.from_numpy(_draws(7))
    img, lab = (torch.from_numpy(a) for a in _batch(8))
    for impl in ("xla", "pallas"):
        _, cfg = _cfgs(impl)
        want, _ = pipeline.augment_batch(None, img, lab, cfg, draws=d)
        got = pipeline.augment_images(None, img, cfg, draws=d)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_draw_params_ranges():
    _, cfg = _cfgs("pallas")
    gen = torch.Generator().manual_seed(0)
    d = pipeline.draw_params(gen, cfg, 4096, "cpu").numpy()
    assert set(np.unique(d[:, 0])) == {0.0, 1.0}
    assert np.abs(d[:, 1]).max() <= np.deg2rad(cfg.rotate_degrees) + 1e-6
    assert d[:, 2].min() >= 0.9 and d[:, 2].max() <= 1.1
    assert np.abs(d[:, 3:]).max() <= cfg.shift_pixels
    no_flip = dataclasses.replace(cfg, flip=False)
    assert not pipeline.draw_params(gen, no_flip, 64, "cpu")[:, 0].any()


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.empty((1, 8, 8, 3), device="meta")
    c = torch.empty((1, 6), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        warp.warp_affine(x, c)


def test_cpu_runs_plain_version_and_counts_nothing():
    img, lab = (torch.from_numpy(a) for a in _batch(9))
    packed = torch.cat([img, lab], -1)
    coefs = _torch_coefs(_draws(10))
    before = warp.LAUNCHES
    got = warp.warp_affine(packed, coefs, n_image=3)
    assert torch.equal(got, warp.warp_affine_reference(packed, coefs, 3))
    assert warp.LAUNCHES == before
