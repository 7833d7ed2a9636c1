"""Adaptation (T2) in the port against the JAX package, on the CPU.

One adapt step (``augment=False``) from an identical state and batch goes
through both packages for each branch of ``make_adapt_step``; the new
critic, DAM, target BN, both optimizer states and the metrics are compared.

Tolerances (f32): losses and feature divergences rtol 1e-4 (a whole
train-mode forward, whose batch-statistic BN cancels in E[x^2] - E[x]^2);
target BN atol 2e-5; gradients, read from Adam's first moment
(mu = (1 - beta1) g after one step), rtol 1e-4 of the largest |g| of each
tensor (floored at 1e-2 of the largest of the tree, for tensors whose
gradient is mathematically zero); the Adam update atol 1e-6 where
|g| > 1e-3 of the tree's largest.  Where |g| is at
rounding level, Adam's first step is lr * sign(g) and the sign may differ
between the packages, so there the update is only held to its size
(<= lr).  ``d_acc`` must be equal: it gates the throttle.

With ``src_feats_bf16`` the frozen source forward runs in bf16 and the two
frameworks round its convs at different places (one bf16 ulp is 2^-8 of a
value, and the JAX package runs the thin stages in its space-to-depth
layout); a last-bit difference grows through the random network's depth
and its batch-statistic BN, so the deepest tap's source features differ
most.  Measured on this case: d_loss 2.5e-3 relative, feat_mmd 1.2e-2, the
critic's rm5 compress gradient 7e-2 of the critic's largest gradient, the
DAM's gradients (which see the source only through the post-step critic)
4e-4.  Held to: losses rtol 1e-2, feature divergences 3e-2, the critic's
gradients atol 0.1 of its largest, the DAM's rtol 2e-3; ``d_acc`` exact
and the target BN 2e-5 (the target path is f32).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcmda_tpu import config as jcfg
from mcmda_tpu.models import critic as jcritic
from mcmda_tpu.models import segmenter as jseg
from mcmda_tpu.train import adapt as jadapt
from mcmda_tpu_torch import config as tcfg
from mcmda_tpu_torch.kernels import train_conv
from mcmda_tpu_torch.train import adapt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _fill(shapes, rng):
    """Seeded numpy leaves for a tree of shapes: He-normal convs, perturbed
    BN affine, non-trivial BN statistics, small biases."""
    def fill(kp, leaf):
        name = jax.tree_util.keystr(kp)
        if name.endswith("['w']"):
            a = rng.standard_normal(leaf.shape) * np.sqrt(
                2.0 / np.prod(leaf.shape[:-1]))
        elif name.endswith("['scale']"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif name.endswith("['var']"):
            a = rng.uniform(0.5, 2.0, leaf.shape)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _shipped_adapt(**kw):
    with open(os.path.join(ROOT, "configs", "mri2ct.json")) as f:
        a = jcfg.ExperimentConfig.from_json(f.read()).adapt
    return dataclasses.replace(a, **kw)


def _states(cfg, seed=0):
    """A JAX and a port AdaptState from the same numpy weights."""
    rng = np.random.default_rng(seed)
    params, bn = _fill(jax.eval_shape(
        lambda: jseg.init(jax.random.key(0), cfg.segmenter)), rng)
    cparams = _fill(jax.eval_shape(lambda: jcritic.init(
        jax.random.key(0), cfg.critic, cfg.segmenter)), rng)
    j = jadapt.init_state(jax.random.key(1), cfg, params, bn)
    _, jtx_d = jadapt.make_txs(cfg)
    jc = jax.tree.map(jnp.asarray, cparams)
    j = j.replace(critic_params=jc, opt_d_state=jtx_d.init(jc))
    t_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())
    t = adapt.init_state(0, t_cfg, _t(params), _t(bn))
    _, ttx_d = adapt.make_txs(t_cfg)
    t = dataclasses.replace(t, critic_params=_t(cparams),
                            opt_d_state=ttx_d.init(_t(cparams)))
    return j, t, t_cfg


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    s = cfg.data.slice_size
    shape = (cfg.data.batch_size, s, s, cfg.data.context_slices)
    src = rng.normal(size=shape).astype(np.float32)
    tgt = (0.5 + 1.5 * rng.normal(size=shape)).astype(np.float32)
    return src, tgt


def _run_both(cfg, train_g=True, seed=0):
    j0, t0, t_cfg = _states(cfg, seed)
    src, tgt = _batch(cfg)
    with pltpu.force_tpu_interpret_mode():
        j1, jm = jax.jit(jadapt.make_adapt_step(
            cfg, train_g=train_g, augment=False))(
            j0, {"src_image": jnp.asarray(src), "tgt_image": jnp.asarray(tgt)},
            jax.random.key(0))
    t1, tm = adapt.make_adapt_step(t_cfg, train_g=train_g, augment=False)(
        t0, {"src_image": torch.from_numpy(src),
             "tgt_image": torch.from_numpy(tgt)}, 0)
    return j0, j1, jm, t0, t1, tm


def _paired(jtree, ttree):
    """(keystr, jax leaf, port leaf) over a JAX tree and the port's tree of
    the same structure."""
    for kp, jl in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = ttree
        for k in kp:
            if isinstance(k, jax.tree_util.DictKey):
                node = node[k.key]
            elif isinstance(k, jax.tree_util.SequenceKey):
                node = node[k.idx]
            else:
                node = getattr(node, k.name)
        yield jax.tree_util.keystr(kp), np.asarray(jl), node.numpy()


def _tree_max(jtree):
    return max(float(np.abs(np.asarray(x)).max())
               for x in jax.tree.leaves(jtree))


def _check_grads(jopt, topt, rel, what, floor=1e-2):
    """Adam's first moment after one step is (1 - beta1) * g.  A tensor
    whose gradient is mathematically zero (a conv bias before an instance
    norm) holds rounding noise only: its scale is floored at ``floor`` of
    the tree's largest gradient."""
    for moment, r in (("mu", rel), ("nu", 2 * rel)):
        jt, tt = getattr(jopt[0], moment), getattr(topt[0], moment)
        floor = floor * _tree_max(jt)
        for key, a, b in _paired(jt, tt):
            scale = max(np.abs(a).max(), floor)
            np.testing.assert_allclose(b, a, rtol=r, atol=r * scale,
                                       err_msg=f"{what} {moment} {key}")
    for key, jc, tc in _paired(jopt, topt):
        if key.endswith(".count"):
            assert int(jc) == int(tc), f"{what} {key}"


def _check_update(jold, jnew, told, tnew, jmu, lr, what):
    big = _tree_max(jmu)
    for (key, a0, b0), (_, a1, b1), (_, mu, _) in zip(
            _paired(jold, told), _paired(jnew, tnew), _paired(jmu, told)):
        du_j, du_t = a1 - a0, b1 - b0
        sure = np.abs(mu) > 1e-3 * big
        np.testing.assert_allclose(du_t[sure], du_j[sure], atol=1e-6,
                                   err_msg=f"{what} update {key}")
        assert np.all(np.abs(du_t) <= lr * (1 + 1e-3) + 1e-7), key


def _check_step(cfg, j0, j1, jm, t0, t1, tm, bf16=False, train_g=True):
    assert set(tm) == set(jm)
    for k in jm:
        if k == "d_acc":
            assert float(tm[k]) == float(jm[k])
        else:
            rtol = (1e-4 if not bf16 else 3e-2 if k.startswith("feat")
                    else 1e-2)
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=rtol, atol=1e-7, err_msg=k)
    for key, a, b in _paired(j1.tgt_bn, t1.tgt_bn):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=2e-5, err_msg=key)
    a = cfg.adapt
    kd_first = a.k_d == 1
    if kd_first:  # one critic step: mu holds exactly its gradient
        if bf16:
            _check_grads(j1.opt_d_state, t1.opt_d_state, 0.1, "critic",
                         floor=1.0)
        else:
            _check_grads(j1.opt_d_state, t1.opt_d_state, 1e-4, "critic")
        if not bf16:
            _check_update(j0.critic_params, j1.critic_params,
                          t0.critic_params, t1.critic_params,
                          j1.opt_d_state[0].mu, a.lr_d, "critic")
    if train_g and a.k_g == 1:
        _check_grads(j1.opt_g_state, t1.opt_g_state, 2e-3 if bf16 else 1e-4,
                     "DAM")
        if not bf16:
            _check_update(j0.dam_params, j1.dam_params, t0.dam_params,
                          t1.dam_params, j1.opt_g_state[0].mu, a.lr_g, "DAM")
    assert int(t1.step) == int(j1.step) == 1
    if a.dam_ema > 0:
        np.testing.assert_allclose(float(t1.ema_w), float(j1.ema_w),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(t1.eq_smooth), float(j1.eq_smooth),
                                   rtol=1e-6)
        for key, x, y in _paired(j1.avg_dam, t1.avg_dam):
            np.testing.assert_allclose(y, x, atol=1e-6, err_msg=key)
        for key, x, y in _paired(j1.avg_bn, t1.avg_bn):
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=2e-5,
                                       err_msg=key)
    else:
        assert t1.ema_w is None and t1.avg_dam is None


CASES = {
    "mri2ct": dict(src_feats_bf16=False),
    "mri2ct_bf16": dict(src_feats_bf16=True),
    "nonsat": dict(src_feats_bf16=False, gan_loss="nonsat"),
    "hlm_frozen": dict(src_feats_bf16=False, hlm_bn="frozen"),
    "two_forward": dict(src_feats_bf16=False, share_tgt_fwd=False),
    "batch_critic": dict(src_feats_bf16=False, batch_critic=True),
    "r1": dict(src_feats_bf16=False, r1_gamma=2.0),
    "dam_ema_gate": dict(src_feats_bf16=False, dam_ema=0.5, ema_gate=0.3,
                         ema_gate_smooth=0.5),
    "kd2_kg2": dict(src_feats_bf16=False, k_d=2, k_g=2),
    "pretrain": dict(src_feats_bf16=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_adapt_step_matches_jax(tiny_config, case):
    """One adapt step per branch, from identical states and batches."""
    kw = dict(CASES[case])
    # the shipped block's cap (0.75) would hold the critic at random init
    # in some cases; every case but the throttle test updates both nets
    kw.setdefault("d_acc_cap", 1.0)
    cfg = dataclasses.replace(tiny_config, adapt=_shipped_adapt(
        plug_depth="rm2", **kw))
    train_g = case != "pretrain"
    j0, j1, jm, t0, t1, tm = _run_both(cfg, train_g=train_g)
    _check_step(cfg, j0, j1, jm, t0, t1, tm, bf16=case == "mri2ct_bf16",
                train_g=train_g)
    if not train_g:  # the critic pretrain phase leaves the DAM alone
        assert "g_loss" not in tm
        for x, y in zip(jax.tree.leaves(t0.dam_params),
                        jax.tree.leaves(t1.dam_params)):
            assert torch.equal(x, y)


def test_shipped_cap_step_matches_jax(tiny_config):
    """The shipped block as it is (cap 0.75, cosine, lsgan), f32 source."""
    cfg = dataclasses.replace(tiny_config, adapt=_shipped_adapt(
        src_feats_bf16=False, plug_depth="rm2"))
    _check_step(cfg, *_run_both(cfg, seed=3))


def test_throttle_holds_critic_bitwise(tiny_config):
    """d_acc_cap=0: the critic step is a true no-op, its params and its
    whole optimizer state (Adam count, moments, schedule count) held bit
    for bit, decided on the device."""
    cfg = dataclasses.replace(tiny_config, adapt=_shipped_adapt(
        src_feats_bf16=False, plug_depth="rm2", d_acc_cap=0.0))
    j0, t0, t_cfg = _states(cfg)
    src, tgt = _batch(cfg)
    t1, m = adapt.make_adapt_step(t_cfg, augment=False)(
        t0, {"src_image": torch.from_numpy(src),
             "tgt_image": torch.from_numpy(tgt)}, 0)
    for x, y in zip(jax.tree.leaves(t0.critic_params),
                    jax.tree.leaves(t1.critic_params)):
        assert torch.equal(x, y)
    for key, x, y in _paired(t0.opt_d_state, t1.opt_d_state):
        np.testing.assert_array_equal(x, y, err_msg=key)
    assert float(m["d_acc"]) > 0.0  # the gate closed on a real accuracy
    # ...and the DAM still trained
    assert any(not torch.equal(x, y) for x, y in zip(
        jax.tree.leaves(t0.dam_params), jax.tree.leaves(t1.dam_params)))


@pytest.mark.parametrize("kd,kg", [(1, 1), (2, 2)])
def test_shared_forward_matches_two_forward(tiny_config, kd, kg):
    """share_tgt_fwd (one target forward feeding both phases) against the
    two-forward oracle over 3 steps, as the JAX package's test holds them."""
    base = _shipped_adapt(src_feats_bf16=False, plug_depth="rm2", k_d=kd,
                          k_g=kg, d_acc_cap=1.0)
    cfgs = [dataclasses.replace(tiny_config, adapt=dataclasses.replace(
        base, share_tgt_fwd=share)) for share in (True, False)]
    _, t0, t_cfg = _states(cfgs[0])
    src, tgt = _batch(cfgs[0])
    batch = {"src_image": torch.from_numpy(src),
             "tgt_image": torch.from_numpy(tgt)}
    out = []
    for c in cfgs:
        step = adapt.make_adapt_step(
            tcfg.ExperimentConfig.from_json(c.to_json()), augment=False)
        s = t0
        for i in range(3):
            s, m = step(s, batch, i)
        out.append((s, m))
    (sa, ma), (sb, mb) = out
    for x, y in zip(
            jax.tree.leaves((sa.dam_params, sa.critic_params, sa.tgt_bn)),
            jax.tree.leaves((sb.dam_params, sb.critic_params, sb.tgt_bn))):
        torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-6)
    for key, x, y in _paired(sa.opt_g_state, sb.opt_g_state):
        np.testing.assert_allclose(x, y, rtol=2e-5, atol=2e-6, err_msg=key)
    for k in ma:
        np.testing.assert_allclose(float(ma[k]), float(mb[k]), rtol=2e-5,
                                   atol=2e-6)


FUSED_STAGES = (
    jcfg.StageSpec("stem", 8, 1, 1, 1),
    jcfg.StageSpec("rm1", 8, 2, 1, 1),
    jcfg.StageSpec("rm2", 16, 2, 1, 1),
    jcfg.StageSpec("rm3", 128, 2, 1, 1),
    jcfg.StageSpec("rm4", 128, 1, 2, 1),
)


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_adapt_step_counts_conv_stats(tiny_config, monkeypatch, bf16):
    """128-wide stages with train_fused="pallas" and the shipped plug depth
    rm3: the port's step goes through ConvStats at 3 sites per f32 forward
    (rm3's stride-1 conv2, rm4's two convs): the shared target forward, and
    the source forward unless it runs in bf16.  The f32 step matches the
    JAX step (its conv + moments kernel in interpret mode)."""
    calls = []
    real = train_conv.conv_stats_forward

    def count(x, w, dilation=1):
        calls.append(tuple(x.shape))
        return real(x, w, dilation)

    monkeypatch.setattr(train_conv, "conv_stats_forward", count)
    cfg = dataclasses.replace(
        tiny_config,
        segmenter=dataclasses.replace(tiny_config.segmenter,
                                      stages=FUSED_STAGES,
                                      train_fused="pallas"),
        critic=dataclasses.replace(tiny_config.critic, taps=("rm3", "rm4")),
        adapt=_shipped_adapt(src_feats_bf16=bf16, d_acc_cap=1.0))
    if bf16:
        _, t0, t_cfg = _states(cfg)
        src, tgt = _batch(cfg)
        adapt.make_adapt_step(t_cfg, augment=False)(
            t0, {"src_image": torch.from_numpy(src),
                 "tgt_image": torch.from_numpy(tgt)}, 0)
    else:
        _check_step(cfg, *_run_both(cfg))
    assert len(calls) == 3 * (1 if bf16 else 2)


def test_adapt_checkpoint_both_ways(tiny_config, tmp_path):
    """The whole AdaptState (critic, both optimizer states with the cosine
    schedule, the step, the weight-average trees) round-trips through npz
    in the JAX key layout in both directions."""
    from mcmda_tpu.utils import checkpoint as jckpt
    from mcmda_tpu_torch import weights
    from mcmda_tpu_torch.train import loop
    from mcmda_tpu_torch.utils import checkpoint

    cfg = dataclasses.replace(tiny_config, adapt=_shipped_adapt(
        src_feats_bf16=False, plug_depth="rm2", dam_ema=0.5, d_acc_cap=1.0))
    j0, j1, _, t0, t1, _ = _run_both(cfg)
    path = checkpoint.save(str(tmp_path / "port"), t1, step=1)
    flat = weights.flatten_state(t1)
    assert set(flat) == set(jckpt._flatten(j1))
    assert ".opt_d_state[1].count" in flat and ".ema_w" in flat
    restored = jckpt._flatten(jckpt.restore(path, j0))
    for k, v in flat.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
        assert restored[k].dtype == v.dtype, k
    # the JAX package's checkpoint, resumed by the port
    jdir = tmp_path / "jax"
    jdir.mkdir()
    np.savez(jdir / "step_00000001.npz", **jckpt._flatten(j1))
    state, start = loop.maybe_resume(str(jdir), t0)
    assert start == 1 and int(state.step) == 1
    got = weights.flatten_state(state)
    for k, v in jckpt._flatten(j1).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # ...and steps on from there
    src, tgt = _batch(cfg)
    s2, m = adapt.make_adapt_step(
        tcfg.ExperimentConfig.from_json(cfg.to_json()), augment=False)(
        state, {"src_image": torch.from_numpy(src),
                "tgt_image": torch.from_numpy(tgt)}, 1)
    assert int(s2.opt_d_state[1].count) == 2 and np.isfinite(
        float(m["g_loss"]))


def test_device_resident_sampling_and_augment(tiny_config):
    """sample_from_device + augmentation (the CLI's path) runs and draws a
    different batch for another seed."""
    from mcmda_tpu_torch.data import pipeline, synthetic, volumes

    cfg = dataclasses.replace(tiny_config, adapt=_shipped_adapt(
        plug_depth="rm2"), data=dataclasses.replace(tiny_config.data,
                                                    warp="pallas"))
    _, t0, t_cfg = _states(cfg)
    data = {}
    for name, dom in (("src", "mri"), ("tgt", "ct")):
        vols, _ = synthetic.make_dataset(0, dom, 1, 8, 32)
        data[name] = pipeline.to_device_arrays(
            volumes.volumes_to_slices(vols, context=3), device="cpu")
    step = adapt.make_adapt_step(t_cfg, sample_from_device=True)
    _, m1 = step(t0, data, 1)
    _, m2 = step(t0, data, 2)
    assert np.isfinite(float(m1["d_loss"])) and np.isfinite(
        float(m1["g_loss"]))
    assert float(m1["d_loss"]) != float(m2["d_loss"])


def test_adapted_forward_and_eval_weights_match_jax(tiny_config):
    """The eval forward of the adapted net, live and EMA-averaged."""
    cfg = dataclasses.replace(tiny_config, adapt=_shipped_adapt(
        src_feats_bf16=False, plug_depth="rm2", dam_ema=0.5, d_acc_cap=1.0))
    _, j1, _, _, t1, _ = _run_both(cfg)
    _, tgt = _batch(cfg, 5)
    t_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())
    for use_avg in (False, True):
        want = jax.jit(jadapt.adapted_forward(cfg, use_avg))(
            j1, jnp.asarray(tgt))
        with torch.no_grad():
            got = adapt.adapted_forward(t_cfg, use_avg)(
                t1, torch.from_numpy(tgt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert json.loads(t_cfg.to_json())["adapt"]["dam_ema"] == 0.5
