"""The port's conv + BN-moments op and the train-mode blocks against the JAX
package, on the CPU.

Same numpy-seeded inputs go through both.  On the CPU the port's
``conv_stats`` runs its plain version under the same autograd Function the
CUDA kernel runs under, so the backward checked here is the one the card
runs.  The JAX side runs its Pallas kernel in TPU-interpret mode, as
``tests/test_train_conv.py`` does, where the kernel path is the point.
The CUDA kernel itself is checked on the card (``chip_smoke.py`` and
``test_torch_kernel_gpu.py``).

Tolerances: z and activations atol 1e-4 (f32, different summation orders
over 9*128 products, as ``test_train_conv.py``); the moments relative 1e-5
of their sums; gradients rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcmda_tpu.cli import _load_config as jload_config
from mcmda_tpu.kernels import train_conv as jtc
from mcmda_tpu.models import segmenter as jseg
from mcmda_tpu.ops import blocks as jblocks
from mcmda_tpu_torch import config as tcfg
from mcmda_tpu_torch.kernels import train_conv as tc
from mcmda_tpu_torch.ops import blocks

import chip_smoke


def _x_w(seed, n=2, h=8, c=128, k=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, h, c)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c, k)) * np.sqrt(2.0 / (9 * c))) \
        .astype(np.float32)
    return x, w


@pytest.mark.parametrize("dilation", [2, 4])
def test_conv_stats_matches_pallas_interpret(dilation):
    x, w = _x_w(dilation)
    with pltpu.force_tpu_interpret_mode():
        jz, js, jss = jtc.conv_stats_pallas(jnp.asarray(x), jnp.asarray(w),
                                            dilation)
    z, s, ss = tc.conv_stats(torch.from_numpy(x), torch.from_numpy(w),
                             dilation)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jz)).sum())
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)


@pytest.mark.parametrize("used", ["all", "z", "moments"])
def test_conv_stats_backward_matches_jax_vjp(used):
    """The Function's analytic backward against ``jax.vjp`` of the JAX
    custom VJP, with cotangents for every output or only some (the others
    arrive as None)."""
    x, w = _x_w(11, h=6, c=8, k=16)
    rng = np.random.default_rng(12)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((2, 6, 6, 16), (16,), (16,))]
    if used == "z":
        cots[1][:] = 0
        cots[2][:] = 0
    elif used == "moments":
        cots[0][:] = 0
    _, vjp = jax.vjp(lambda a, b: jtc.conv_stats(a, b, 2), jnp.asarray(x),
                     jnp.asarray(w))
    jdx, jdw = vjp(tuple(jnp.asarray(c) for c in cots))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    outs = tc.conv_stats(xt, wt, 2)
    keep = {"all": (0, 1, 2), "z": (0,), "moments": (1, 2)}[used]
    dx, dw = torch.autograd.grad([outs[i] for i in keep], (xt, wt),
                                 [torch.from_numpy(cots[i]) for i in keep])
    for got, want in ((dx, jdx), (dw, jdw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def _bn(seed, k):
    rng = np.random.default_rng(seed)
    p = {"scale": rng.uniform(0.5, 1.5, k), "bias": rng.normal(size=k)}
    st = {"mean": 0.1 * rng.normal(size=k), "var": rng.uniform(0.5, 2, k)}
    return ({a: v.astype(np.float32) for a, v in p.items()},
            {a: v.astype(np.float32) for a, v in st.items()})


def _tree(d, lib):
    if isinstance(d, dict):
        return {k: _tree(v, lib) for k, v in d.items()}
    return jnp.asarray(d) if lib == "jax" else torch.from_numpy(np.array(d))


def _assert_tree_close(got, want, atol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k], atol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=atol)


@pytest.mark.parametrize("residual", [False, True])
def test_conv_bn_act_train_matches_jax(residual):
    x, w = _x_w(21, h=6, c=16, k=8)
    p, st = _bn(22, 8)
    r = np.random.default_rng(23).normal(size=(2, 6, 6, 8)) \
        .astype(np.float32) if residual else None
    jy, jst = jtc.conv_bn_act_train(
        {"w": jnp.asarray(w)}, _tree(p, "jax"), _tree(st, "jax"),
        jnp.asarray(x), dilation=2, momentum=0.9, eps=1e-3,
        residual=None if r is None else jnp.asarray(r))
    ty, tst = tc.conv_bn_act_train(
        {"w": torch.from_numpy(w)}, _tree(p, "torch"), _tree(st, "torch"),
        torch.from_numpy(x), dilation=2, momentum=0.9, eps=1e-3,
        residual=None if r is None else torch.from_numpy(r))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
    _assert_tree_close(tst, jst, atol=1e-5)


def _block_trees(seed, cin, cout):
    params, state = jax.eval_shape(
        lambda: jblocks.residual_block_init(jax.random.key(0), cin, cout))
    rng = np.random.default_rng(seed)

    def fill(kp, leaf):
        name = jax.tree_util.keystr(kp)
        if name.endswith("['w']"):
            a = rng.normal(size=leaf.shape) * np.sqrt(
                2.0 / np.prod(leaf.shape[:-1]))
        elif name.endswith("['scale']"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif name.endswith("['var']"):
            a = rng.uniform(0.5, 2.0, leaf.shape)
        else:
            a = 0.1 * rng.normal(size=leaf.shape)
        return a.astype(np.float32)

    return (jax.tree_util.tree_map_with_path(fill, params),
            jax.tree_util.tree_map_with_path(fill, state))


@pytest.mark.parametrize("cin,cout,fused", [(128, 128, True),
                                            (128, 256, True),
                                            (16, 24, False)])
def test_residual_block_train_matches_jax(cin, cout, fused, monkeypatch):
    """Train-mode block with ``fused_train``: the JAX package runs its
    Pallas kernel (interpret mode) exactly where the port's dispatch sends
    the conv to ``conv_bn_act_train``; a narrow block takes the plain
    path on both sides."""
    params, state = _block_trees(cin + cout, cin, cout)
    x = np.random.default_rng(cout).normal(size=(2, 8, 8, cin)) \
        .astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jy, jst = jblocks.residual_block_apply(
            params, state, jnp.asarray(x), dilation=2, train=True,
            fused_train=True)
    calls = []
    real = tc.conv_bn_act_train

    def count(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tc, "conv_bn_act_train", count)
    ty, tst = blocks.residual_block_apply(
        _tree(params, "torch"), _tree(state, "torch"), torch.from_numpy(x),
        dilation=2, train=True, fused_train=True)
    assert len(calls) == (2 if fused else 0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
    _assert_tree_close(tst, jst, atol=1e-5)


def test_fused_dispatch_matches_jax_at_default_stages(monkeypatch):
    """At the shipped config's full-width stages the port sends to the
    conv + moments path exactly the convs (shapes, order) the JAX package
    sends to its Pallas kernel: traced, not run, on the JAX side."""
    sent = []

    def fake(x, w, dilation=1, k_tile=128):
        sent.append((tuple(x.shape), w.shape[-1], dilation))
        return jtc.conv_stats_reference(x, w, dilation)

    cfg = jload_config("configs/mri2ct.json",
                       ["segmenter.train_fused=pallas"])
    monkeypatch.setattr(jtc, "conv_stats_pallas", fake)
    with pltpu.force_tpu_interpret_mode():
        p, s = jax.eval_shape(
            lambda: jseg.init(jax.random.key(0), cfg.segmenter))
        jax.eval_shape(lambda p, s, x: jseg.apply(
            p, s, x, cfg.segmenter, train=True), p, s,
            jax.ShapeDtypeStruct((8, 256, 256, 3), jnp.float32))
    t_cfg = tcfg.load_config("configs/mri2ct.json",
                             ["segmenter.train_fused=pallas"])
    assert chip_smoke.train_call_sites(t_cfg.segmenter, 8, 256) == sent
    assert len(sent) == 15  # rm3's 3 stride-1 convs + 12 of rm4-rm6


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.empty((1, 4, 4, 128), device="meta")
    w = torch.empty((3, 3, 128, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tc.conv_stats_forward(x, w, 2)


def test_cpu_runs_plain_version_and_counts_nothing():
    x, w = (torch.from_numpy(a) for a in _x_w(31, c=16, k=8))
    before = tc.LAUNCHES
    got = tc.conv_stats(x, w, 2)
    want = tc.conv_stats_reference(x, w, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tc.LAUNCHES == before
