"""The port's config, weight bridge and import boundary against the JAX
package, on the CPU."""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmda_tpu import cli as jcli
from mcmda_tpu import config as jcfg
from mcmda_tpu.models import segmenter as jseg
from mcmda_tpu.train import adapt, source
from mcmda_tpu.utils.checkpoint import _flatten
from mcmda_tpu_torch import cli as tcli
from mcmda_tpu_torch import config as tcfg
from mcmda_tpu_torch import weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mcmda_tpu_torch")
CONFIGS = sorted(f for f in os.listdir(os.path.join(ROOT, "configs"))
                 if f.endswith(".json"))


def _as_plain(cfg):
    """dataclasses.asdict with dtype leaves compared by name."""
    d = dataclasses.asdict(cfg)
    d["segmenter"]["compute_dtype"] = jnp.dtype(
        d["segmenter"]["compute_dtype"]).name
    return d


def test_three_shipped_configs():
    assert CONFIGS == ["ct2mri.json", "mri2ct.json", "smoke.json"]


@pytest.mark.parametrize("name", CONFIGS + [None])
def test_from_json_matches_jax(name):
    if name is None:
        want, got = jcfg.ExperimentConfig(), tcfg.ExperimentConfig()
    else:
        with open(os.path.join(ROOT, "configs", name)) as f:
            text = f.read()
        want = jcfg.ExperimentConfig.from_json(text)
        got = tcfg.ExperimentConfig.from_json(text)
    assert dataclasses.asdict(got) == _as_plain(want)
    # and the JSON round trip is exact
    assert tcfg.ExperimentConfig.from_json(got.to_json()) == got


def test_set_overrides_match_jax():
    sets = ["adapt.plug_depth=rm2", "run.use_pallas=true",
            'critic.taps=["rm3","rm5"]', "segmenter.compute_dtype=bfloat16",
            "data.zoom_range=[0.8,1.2]", "run.eval_bf16=false",
            "source.lr=0.5"]
    path = os.path.join(ROOT, "configs", "mri2ct.json")
    want = jcli._load_config(path, sets)
    got = tcfg.load_config(path, sets)
    assert dataclasses.asdict(got) == _as_plain(want)
    assert got.adapt.plug_depth == "rm2" and got.critic.taps == ("rm3", "rm5")
    with pytest.raises(ValueError, match="compute_dtype"):
        tcfg.load_config(path, ["segmenter.compute_dtype=float16"])


def test_eval_view_matches_jax():
    path = os.path.join(ROOT, "configs", "ct2mri.json")
    want = jcfg.eval_view(jcli._load_config(path, []))
    got = tcfg.eval_view(tcfg.load_config(path, []))
    assert got.segmenter.compute_dtype == "bfloat16"
    assert dataclasses.asdict(got) == _as_plain(want)


# ---------------------------------------------------------------- the bridge
STAGES = (jcfg.StageSpec("stem", 4, 1, 1, 1),
          jcfg.StageSpec("rm1", 8, 2, 1, 2),
          jcfg.StageSpec("rm4", 8, 1, 2, 1))


def _cfgs(dam_ema=0.0):
    cfg = jcfg.ExperimentConfig(
        segmenter=jcfg.SegmenterConfig(stages=STAGES),
        adapt=jcfg.AdaptConfig(plug_depth="rm1", dam_ema=dam_ema))
    return cfg, tcfg.ExperimentConfig.from_json(cfg.to_json())


def _numpy_trees(cfg, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jseg.init(jax.random.key(0), cfg))
    return jax.tree.map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32), shapes)


def _adapt_state(cfg, seed, ema_w=None):
    params, bn = _numpy_trees(cfg.segmenter, seed)
    tgt_bn = _numpy_trees(cfg.segmenter, seed + 1)[1]
    dam, _ = jseg.dam_split(_numpy_trees(cfg.segmenter, seed + 2)[0],
                            cfg.segmenter, cfg.adapt.plug_depth)
    extra = {}
    if ema_w is not None:
        avg_dam, _ = jseg.dam_split(_numpy_trees(cfg.segmenter, seed + 3)[0],
                                    cfg.segmenter, cfg.adapt.plug_depth)
        extra = dict(avg_dam=avg_dam,
                     avg_bn=_numpy_trees(cfg.segmenter, seed + 4)[1],
                     ema_w=np.float32(ema_w), eq_smooth=np.float32(0.1))
    return adapt.AdaptState(src_params=params, src_bn=bn, dam_params=dam,
                            tgt_bn=tgt_bn, critic_params=None,
                            opt_g_state=None, opt_d_state=None,
                            step=np.int32(3), **extra)


def test_source_round_trip(tmp_path):
    cfg, t_cfg = _cfgs()
    params, bn = _numpy_trees(cfg.segmenter, 0)
    flat = _flatten(source.SourceState(params=params, bn_state=bn,
                                       opt_state=None, step=np.int32(5)))
    np.savez(tmp_path / "step_00000005.npz", **flat)
    tp, tb = weights.restore_source(str(tmp_path / "step_00000005"), t_cfg,
                                    "cpu")
    back = {**weights.flatten(tp, "params"), **weights.flatten(tb, "bn_state")}
    assert back.keys() == flat.keys() - {".step"}
    for k, v in back.items():
        np.testing.assert_array_equal(v, flat[k])
    assert tp["rm1"]["b0"]["conv1"]["w"].dtype == torch.float32


def test_adapt_round_trip(tmp_path):
    cfg, t_cfg = _cfgs(dam_ema=0.5)
    flat = _flatten(_adapt_state(cfg, 0, ema_w=0.25))
    path = str(tmp_path / "a.npz")
    np.savez(path, **flat)
    st = weights.restore_adapt(path, t_cfg, "cpu")
    back = {}
    for field in ("src_params", "src_bn", "dam_params", "tgt_bn", "avg_dam",
                  "avg_bn"):
        back.update(weights.flatten(st[field], field))
    assert set(st["dam_params"]) == {"stem", "rm1"}
    assert back.keys() == flat.keys() - {".step", ".ema_w", ".eq_smooth"}
    for k, v in back.items():
        np.testing.assert_array_equal(v, flat[k])
    assert float(st["ema_w"]) == 0.25


@pytest.mark.parametrize("use_avg,ema_w", [(False, 0.25), (True, 0.25),
                                           (True, 0.0), (True, None)])
def test_eval_weights_matches_jax(tmp_path, use_avg, ema_w):
    cfg, t_cfg = _cfgs(dam_ema=0.5 if ema_w is not None else 0.0)
    state = _adapt_state(cfg, 7, ema_w=ema_w)
    np.savez(tmp_path / "a.npz", **_flatten(state))
    st = weights.restore_adapt(str(tmp_path / "a.npz"), t_cfg, "cpu")
    want = adapt.eval_weights(jax.tree.map(jnp.asarray, state), use_avg)
    got = weights.eval_weights(st, use_avg)
    for field, w, g in zip(("dam", "bn"), want, got):
        wf = {k: np.asarray(v) for k, v in _flatten(w).items()}
        gf = {k[1:]: v for k, v in weights.flatten(g, "").items()}
        assert wf.keys() == gf.keys(), field
        for k in wf:
            np.testing.assert_allclose(gf[k], wf[k], rtol=1e-6)


def test_shape_mismatch_raises(tmp_path):
    cfg, _ = _cfgs()
    params, bn = _numpy_trees(cfg.segmenter, 0)
    np.savez(tmp_path / "s.npz", **_flatten(source.SourceState(
        params=params, bn_state=bn, opt_state=None, step=np.int32(0))))
    wider = tcfg.ExperimentConfig(segmenter=tcfg.SegmenterConfig(stages=(
        tcfg.StageSpec("stem", 4, 1, 1, 1), tcfg.StageSpec("rm1", 16, 2, 1, 2),
        tcfg.StageSpec("rm4", 8, 1, 2, 1))))
    with pytest.raises(ValueError, match="shape"):
        weights.restore_source(str(tmp_path / "s.npz"), wider, "cpu")


@pytest.mark.parametrize("reader", ["tensorstore", "hidden"])
def test_orbax_directory_raises(tmp_path, monkeypatch, reader):
    """A run directory whose newest step is an unfinished orbax directory
    (no ``_METADATA``): with the reader, ``--ckpt`` resolves it and its
    restore raises; without ``tensorstore`` ``--ckpt`` refuses it as
    ``--out``'s resume does (checkpoint.latest_step), and so does a restore
    of the step path itself."""
    (tmp_path / "run" / "step_00000007").mkdir(parents=True)
    cfg, t_cfg = _cfgs()
    if reader == "hidden":
        monkeypatch.setitem(sys.modules, "tensorstore", None)
        with pytest.raises(ValueError, match="orbax"):
            tcli._resolve_ckpt(str(tmp_path / "run"))
    else:
        pytest.importorskip("tensorstore")
        assert tcli._resolve_ckpt(str(tmp_path / "run")) == \
            str(tmp_path / "run" / "step_00000007")
    with pytest.raises(ValueError, match="orbax"):
        weights.restore_source(str(tmp_path / "run" / "step_00000007"),
                               t_cfg, "cpu")


def test_cli_resolves_selection_and_latest(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    for s in (100, 200):
        np.savez(run / f"step_{s:08d}.npz", x=np.zeros(1))
    assert tcli._resolve_ckpt(str(run)) == str(run / "step_00000200")
    (run / "selection.json").write_text('{"best_step": 100, '
                                        '"weights": "avg"}')
    assert tcli._resolve_ckpt(str(run)) == str(run / "step_00000100")
    assert tcli._selected_weights(str(run / "step_00000100")) == "avg"
    assert tcli._selected_weights(str(run / "step_00000200")) is None
    assert jcli._resolve_ckpt(str(run)) == tcli._resolve_ckpt(str(run))


def test_predict_without_gpu_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["predict", "--ckpt", str(tmp_path), "--input",
                   str(tmp_path), "--out", str(tmp_path / "o")])


# ------------------------------------------------- copied host-side modules
@pytest.mark.parametrize("domain", ["mri", "ct"])
def test_synthetic_volume_matches_jax_package(domain):
    from mcmda_tpu.data import synthetic as jsyn
    from mcmda_tpu_torch.data import synthetic as tsyn
    want = jsyn.make_volume(np.random.default_rng(5), domain, 6, 24)
    got = tsyn.make_volume(np.random.default_rng(5), domain, 6, 24)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_postprocess_matches_jax_package():
    from mcmda_tpu.evaluation import postprocess as jpp
    from mcmda_tpu_torch.data import splits
    from mcmda_tpu_torch.evaluation import postprocess as tpp
    pred = np.random.default_rng(6).integers(0, 5, (6, 16, 16))
    np.testing.assert_array_equal(
        tpp.get("cc")(pred, splits.STRUCTURES),
        jpp.get("cc")(pred, splits.STRUCTURES))
    assert tpp.get("none") is None


# ------------------------------------------------------- the import boundary
def test_port_sources_never_import_jax_or_the_reference():
    bad = re.compile(r"^\s*(import jax|from jax|import mcmda_tpu\b(?!_torch)"
                     r"|from mcmda_tpu[ .](?!_torch))", re.M)
    hits = []
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(d, f)).read()
                hits += [f"{f}: {m.group(0)}" for m in bad.finditer(text)]
    assert hits == []


def test_importing_the_port_leaves_jax_out():
    code = ("import pkgutil, sys, mcmda_tpu_torch\n"
            "for m in pkgutil.walk_packages(mcmda_tpu_torch.__path__,"
            " 'mcmda_tpu_torch.'):\n"
            "    if m.name != 'mcmda_tpu_torch.__main__':\n"
            "        __import__(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or"
            " m.startswith(('jax.', 'mcmda_tpu.')) or m == 'mcmda_tpu']\n"
            "assert not bad, bad\n"
            "print('ok', len([m for m in sys.modules"
            " if m.startswith('mcmda_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
