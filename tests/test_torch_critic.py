"""The feature critic, the adversarial losses and the resize ops of the
port against the JAX package, on the CPU.

Tolerances: f32 atol 2e-5 (convs and instance norm summed in another
order); losses rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmda_tpu import config as jcfg
from mcmda_tpu.models import critic as jcritic
from mcmda_tpu.ops import layers as jlayers
from mcmda_tpu.ops import losses as jlosses
from mcmda_tpu.ops import metrics as jmetrics
from mcmda_tpu_torch import config as tcfg
from mcmda_tpu_torch import weights
from mcmda_tpu_torch.models import critic
from mcmda_tpu_torch.ops import layers, losses, metrics

ATOL = 2e-5


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _critic_params(cfg, seg_cfg, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jcritic.init(jax.random.key(0), cfg,
                                                 seg_cfg))

    def fill(kp, leaf):
        scale = 0.1 if jax.tree_util.keystr(kp).endswith("['b']") else \
            np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _taps(seg_cfg, sizes, seed, n=3):
    rng = np.random.default_rng(seed)
    chans = jcritic.tap_channels(seg_cfg)
    return {t: rng.normal(size=(n, s, s, chans[t])).astype(np.float32)
            for t, s in sizes.items()}


@pytest.mark.parametrize("mode,sizes", [
    ("concat", {"rm4": 8, "rm5": 8}),
    ("multi", {"rm4": 8, "rm5": 8}),
    ("concat", {"rm4": 16, "rm5": 8}),    # rm4 resized down (antialiased)
    ("concat", {"rm4": 8, "rm5": 16}),    # and the other way round
])
def test_critic_apply_matches_jax(tiny_config, mode, sizes):
    cfg = dataclasses.replace(tiny_config.critic, mode=mode)
    seg = tiny_config.segmenter
    p = _critic_params(cfg, seg, 0)
    taps = _taps(seg, sizes, 1)
    want = jcritic.apply(jax.tree.map(jnp.asarray, p),
                         {k: jnp.asarray(v) for k, v in taps.items()}, cfg)
    t_cfg = tcfg.CriticConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)})
    got = critic.apply(_t(p), {k: torch.from_numpy(v)
                               for k, v in taps.items()}, t_cfg)
    if mode == "multi":
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(critic.flatten_logits(got).numpy(),
                               np.asarray(jcritic.flatten_logits(want)),
                               atol=ATOL)


def test_shipped_critic_shapes_and_padding():
    """The shipped critic on full-width taps (rm4, rm6 at 32x32, 256 and
    512 channels): the stride-1 last 4x4 conv on a 4x4 grid pads (1, 2), as
    XLA's SAME does."""
    cfg = jcfg.ExperimentConfig()
    p = _critic_params(cfg.critic, cfg.segmenter, 2)
    taps = _taps(cfg.segmenter, {"rm4": 32, "rm6": 32}, 3, n=1)
    want = jcritic.apply(jax.tree.map(jnp.asarray, p),
                         {k: jnp.asarray(v) for k, v in taps.items()},
                         cfg.critic)
    got = critic.apply(_t(p), {k: torch.from_numpy(v)
                               for k, v in taps.items()},
                       tcfg.ExperimentConfig().critic)
    assert tuple(got.shape) == (1, 4, 4, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert layers.same_padding(4, 4, 1, 1) == (1, 2)


def test_critic_init_tree_and_bridge(tiny_config):
    """init keeps the JAX tree and shapes; the tree flattens to the JAX
    checkpoint keys and back."""
    for mode in ("concat", "multi"):
        cfg = dataclasses.replace(tiny_config.critic, mode=mode)
        want = jax.eval_shape(lambda: jcritic.init(
            jax.random.key(0), cfg, tiny_config.segmenter))
        t_cfg = tcfg.ExperimentConfig.from_json(dataclasses.replace(
            tiny_config, critic=cfg).to_json())
        got = critic.init(t_cfg.critic, t_cfg.segmenter,
                          generator=torch.Generator().manual_seed(0))
        flat = weights.flatten(got, "critic_params")
        jflat = {".critic_params" + jax.tree_util.keystr(kp): leaf for
                 kp, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
        assert set(flat) == set(jflat)
        for k, v in flat.items():
            assert v.shape == jflat[k].shape, k
        back = weights.subtree(flat, "critic_params")
        for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(got)):
            np.testing.assert_array_equal(x, y.numpy())
    with pytest.raises(ValueError, match="not a segmenter stage"):
        critic.init(tcfg.CriticConfig(taps=("nope",)),
                    tcfg.SegmenterConfig())


@pytest.mark.parametrize("hw,out", [((8, 8), (16, 16)), ((16, 12), (8, 4)),
                                    ((7, 9), (5, 13)), ((32, 32), (32, 32))])
def test_resize_to_matches_jax(hw, out):
    """Up and down (antialiased), odd sizes, the identity."""
    x = np.random.default_rng(4).normal(size=(2, *hw, 3)).astype(np.float32)
    want = jlayers.resize_to(jnp.asarray(x), out)
    got = layers.resize_to(torch.from_numpy(x), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_avg_pool_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 8, 12, 3)).astype(
        np.float32)
    for f in (1, 2, 4):
        np.testing.assert_allclose(
            layers.avg_pool(torch.from_numpy(x), f).numpy(),
            np.asarray(jlayers.avg_pool(jnp.asarray(x), f)), atol=1e-6)
    np.testing.assert_allclose(
        layers.global_avg_pool(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.global_avg_pool(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("kind", ["nonsat", "lsgan"])
@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_gan_losses_match_jax(kind, smooth):
    rng = np.random.default_rng(6)
    ls, lt = (rng.normal(size=(4, 16)).astype(np.float32) for _ in range(2))
    jd, jg = jlosses.gan_losses(kind)
    td, tg = losses.gan_losses(kind)
    np.testing.assert_allclose(
        float(td(torch.from_numpy(ls), torch.from_numpy(lt), smooth)),
        float(jd(jnp.asarray(ls), jnp.asarray(lt), smooth)), rtol=1e-6)
    np.testing.assert_allclose(float(tg(torch.from_numpy(lt))),
                               float(jg(jnp.asarray(lt))), rtol=1e-6)
    b = losses.decision_boundary(kind)
    assert b == jlosses.decision_boundary(kind)
    assert float(losses.critic_accuracy(torch.from_numpy(ls),
                                        torch.from_numpy(lt), b)) == \
        float(jlosses.critic_accuracy(jnp.asarray(ls), jnp.asarray(lt), b))


@pytest.mark.parametrize("kind", ["nonsat", "lsgan"])
def test_gan_losses_directionality(kind):
    """The critic's loss is lower when it separates the domains; the DAM's
    is lower when its features pass as source (``tests/test_ops.py``)."""
    d_fn, g_fn = losses.gan_losses(kind)
    good_s, good_t = torch.full((4, 16), 3.0), torch.full((4, 16), -3.0)
    if kind == "lsgan":
        good_s, good_t = torch.ones(4, 16), torch.zeros(4, 16)
    assert float(d_fn(good_s, good_t)) < float(d_fn(good_t, good_s))
    assert float(g_fn(good_s)) < float(g_fn(good_t))


def test_critic_accuracy_and_boundary():
    s, t = torch.tensor([[1.0, -1.0]]), torch.tensor([[-1.0, 1.0]])
    assert float(losses.critic_accuracy(s, t)) == 0.5
    # lsgan regresses to 1 / 0: logits 0.3 and 0.2 are both "target"
    assert float(losses.critic_accuracy(torch.tensor([[0.3]]),
                                        torch.tensor([[0.2]]), 0.5)) == 0.5
    with pytest.raises(ValueError):
        losses.decision_boundary("wgan")
    with pytest.raises(ValueError):
        losses.gan_losses("wgan")


def test_dice_metrics_match_jax():
    rng = np.random.default_rng(8)
    pred = rng.integers(0, 4, (3, 8, 8))  # class 4 absent from both
    true = rng.integers(0, 4, (3, 8, 8))
    want = jmetrics.dice_per_class(jnp.asarray(pred), jnp.asarray(true), 5)
    got = metrics.dice_per_class(torch.from_numpy(pred),
                                 torch.from_numpy(true), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got[4]) == 0.0
    np.testing.assert_allclose(
        float(metrics.mean_foreground_dice(torch.from_numpy(pred),
                                           torch.from_numpy(true), 5)),
        float(jmetrics.mean_foreground_dice(jnp.asarray(pred),
                                            jnp.asarray(true), 5)),
        rtol=1e-6)
