"""The port's segmenter against the JAX package's, on the CPU.

Weights come from a seeded JAX ``SourceState`` (BN statistics perturbed so
that they are not the identity), written in the JAX npz layout and read
through ``mcmda_tpu_torch.weights``.  f32 logits are held to atol 1e-4;
under ``eval_bf16`` the two frameworks round bf16 at different places, so
logits are held to a few bf16 ulps of their largest value and labels to
99% agreement.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmda_tpu import config as jcfg
from mcmda_tpu.models import segmenter as jseg
from mcmda_tpu.train import source
from mcmda_tpu.utils.checkpoint import _flatten
from mcmda_tpu_torch import config as tcfg
from mcmda_tpu_torch import weights
from mcmda_tpu_torch.kernels import fused_conv as fk
from mcmda_tpu_torch.models import segmenter as tseg

import chip_smoke

STAGES = (
    jcfg.StageSpec("stem", 8, 1, 1, 1),
    jcfg.StageSpec("rm1", 8, 2, 1, 2),
    jcfg.StageSpec("rm2", 16, 2, 1, 2),
    jcfg.StageSpec("rm3", 16, 2, 1, 1),
    jcfg.StageSpec("rm4", 24, 1, 2, 2),
    jcfg.StageSpec("rm5", 24, 1, 4, 1),
)
PLUG = "rm2"


def _random_trees(cfg, seed):
    """Seeded numpy params (He-normal convs, perturbed BN affine) and
    non-trivial BN statistics with the JAX package's tree layout."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jseg.init(jax.random.key(0), cfg))

    def fill(kp, leaf):
        name = jax.tree_util.keystr(kp)
        if name.endswith("['w']"):
            fan_in = np.prod(leaf.shape[:-1])
            a = rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith("['scale']"):
            a = rng.uniform(0.5, 1.0, leaf.shape)
        elif name.endswith("['var']"):
            a = rng.uniform(1.0, 3.0, leaf.shape)
        else:
            a = 0.2 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _perturb(tree, seed):
    """Scale every leaf by 1 + 0.1 N(0,1) (keeps variances positive)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a * (1 + 0.1 * rng.standard_normal(
        a.shape))).astype(np.float32), tree)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    cfg = jcfg.ExperimentConfig(
        segmenter=jcfg.SegmenterConfig(stages=STAGES, thin_layout="nhwc"),
        adapt=jcfg.AdaptConfig(plug_depth=PLUG))
    params, bn = _random_trees(cfg.segmenter, 1)
    st = source.SourceState(params=params, bn_state=bn, opt_state=None,
                            step=np.int32(1))
    path = str(tmp_path_factory.mktemp("ckpt") / "step_00000001.npz")
    np.savez(path, **_flatten(st))
    t_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())
    tp, tb = weights.restore_source(path, t_cfg, "cpu")
    dam_j, _ = jseg.dam_split(params, cfg.segmenter, PLUG)
    dam_j = _perturb(dam_j, 3)
    # the DAM in the AdaptState key layout, read back through the bridge
    dam_t = _to_torch(weights.subtree(
        {".dam_params" + k: v for k, v in _flatten(dam_j).items()},
        "dam_params"))
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)) \
        .astype(np.float32)
    return dict(cfg=cfg, t_cfg=t_cfg, jp=params, jb=bn, tp=tp, tb=tb,
                dam_j=dam_j, dam_t=dam_t, x=x)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _run(m, fn, dam, bf16):
    cfg, t_cfg = m["cfg"], m["t_cfg"]
    if bf16:
        cfg = jcfg.eval_view(dataclasses.replace(
            cfg, run=dataclasses.replace(cfg.run, eval_bf16=True)))
        t_cfg = tcfg.eval_view(dataclasses.replace(
            t_cfg, run=dataclasses.replace(t_cfg.run, eval_bf16=True)))
    dj = dict(dam_params=m["dam_j"], plug_depth=PLUG) if dam else {}
    dt = dict(dam_params=m["dam_t"], plug_depth=PLUG) if dam else {}
    xj, xt = jnp.asarray(m["x"]), torch.from_numpy(m["x"])
    if fn == "apply":
        lj, pj, _, _ = jseg.apply(m["jp"], m["jb"], xj, cfg.segmenter,
                                  train=False, **dj)
        lt, pt = tseg.apply(m["tp"], m["tb"], xt, t_cfg.segmenter, **dt)
    else:
        lj, pj = jseg.apply_fused_eval(m["jp"], m["jb"], xj, cfg.segmenter,
                                       use_pallas=False, **dj)
        lt, pt = tseg.apply_fused_eval(m["tp"], m["tb"], xt, t_cfg.segmenter,
                                       **dt)
    return lj, pj, lt, pt


@pytest.mark.parametrize("dam", [False, True])
@pytest.mark.parametrize("fn", ["apply", "fused"])
def test_forward_matches_jax_f32(models, fn, dam):
    lj, pj, lt, pt = _run(models, fn, dam, bf16=False)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)


@pytest.mark.parametrize("fn", ["apply", "fused"])
def test_forward_matches_jax_eval_bf16(models, fn):
    lj, pj, lt, pt = _run(models, fn, dam=True, bf16=True)
    # apply casts its logits to f32; the fused path returns them in bf16
    want_dtype = torch.float32 if fn == "apply" else torch.bfloat16
    assert lt.dtype == want_dtype and str(lj.dtype) == str(want_dtype)[6:]
    lj = np.asarray(lj, np.float32)
    lt = lt.float().numpy()
    assert np.abs(lt - lj).max() <= np.abs(lj).max() / 32
    agree = (np.asarray(pj, np.float32).argmax(-1)
             == pt.float().numpy().argmax(-1)).mean()
    assert agree >= 0.99, agree


def test_fused_path_dtype_flow(models, monkeypatch):
    """Under eval_bf16 the fused op gets bf16 x after a strided block and a
    bf16 residual in that block's conv2, f32 elsewhere, and always returns
    f32 -- the flow chip_smoke.call_sites enumerates for the card."""
    seen = []
    real = fk.conv_bn_act

    def record(x, w, scale, bias, **kw):
        r = kw.get("residual")
        seen.append((tuple(x.shape), w.shape[-1], kw["dilation"],
                     str(x.dtype)[6:],
                     None if r is None else str(r.dtype)[6:]))
        out = real(x, w, scale, bias, **kw)
        assert out.dtype == torch.float32
        return out

    monkeypatch.setattr(fk, "conv_bn_act", record)
    t_cfg = tcfg.eval_view(dataclasses.replace(
        models["t_cfg"], run=dataclasses.replace(models["t_cfg"].run,
                                                 eval_bf16=True)))
    tseg.apply_fused_eval(models["tp"], models["tb"],
                          torch.from_numpy(models["x"]), t_cfg.segmenter)
    want = [site[1:] for site in chip_smoke.call_sites(t_cfg.segmenter, 2,
                                                       32)]
    assert seen == [(xs, k, d, x_dt, r_dt) for xs, k, d, x_dt, r_dt in want]
    assert len(seen) == 11  # stem + rm1.b1 + rm2.b1 + rm4.b0-b1 + rm5.b0


def test_init_shapes_match_jax(models):
    jp, jb = jax.eval_shape(
        lambda: jseg.init(jax.random.key(0), models["cfg"].segmenter))
    tp, tb = tseg.init(models["t_cfg"].segmenter,
                       generator=torch.Generator().manual_seed(0))
    for j, t in ((jp, tp), (jb, tb)):
        jf = {jax.tree_util.keystr(kp): leaf.shape for kp, leaf
              in jax.tree_util.tree_flatten_with_path(j)[0]}
        tf = {k[1:]: v.shape for k, v in weights.flatten(t, "").items()}
        assert jf == tf


def test_dam_split_merge_match_jax(models):
    cfg, t_cfg = models["cfg"].segmenter, models["t_cfg"].segmenter
    assert tseg.dam_stage_names(t_cfg, PLUG) == \
        jseg.dam_stage_names(cfg, PLUG)
    dam, hlm = tseg.dam_split(models["tp"], t_cfg, PLUG)
    jdam, jhlm = jseg.dam_split(models["jp"], cfg, PLUG)
    assert set(dam) == set(jdam) and set(hlm) == set(jhlm)
    assert tseg.dam_merge(dam, hlm).keys() == models["tp"].keys()
    with pytest.raises(ValueError, match="not a stage"):
        tseg.dam_stage_names(t_cfg, "rm9")
