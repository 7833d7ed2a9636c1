"""The port's library API on the CPU at toy scale: the documented
three-call workflow and its resume semantics (twin of ``tests/test_api.py``),
the API against the JAX package's, and the API against the port's CLI.

Against the JAX package: a ``SourceState`` and an ``AdaptState`` trained by
``mcmda_tpu.api`` are carried across as numpy arrays through the npz key
layout (``weights.unflatten_state``); ``api.predict`` must then give the JAX
package's f32 masks voxel for voxel and ``api.evaluate`` its table (Dice
within 1e-6, ASSD / HD95 within 1e-4), with and without flip TTA and the
connected-component filter.  Training trajectories are not compared: JAX's
threefry and torch's generators never agree.

Against the CLI: with the same config and seeds ``api.train_source`` /
``api.adapt`` and ``train-source`` / ``adapt`` write bitwise-equal final
checkpoints, on the device-resident feed and, with the cutoff set to 0, on
the host-sampler feed.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from mcmda_tpu import api as japi
from mcmda_tpu.utils import checkpoint as jckpt
from mcmda_tpu_torch import api, cli as tcli, config as tcfg, weights
from mcmda_tpu_torch.data import pipeline, synthetic
from mcmda_tpu_torch.evaluation import inference
from mcmda_tpu_torch.models import segmenter
from mcmda_tpu_torch.train import adapt, source


def _port_cfg(cfg):
    return tcfg.ExperimentConfig.from_json(cfg.to_json())


def _with(cfg, **sections):
    """``cfg`` with fields of its sections replaced: _with(cfg,
    run={"ckpt_every": 4})."""
    return dataclasses.replace(cfg, **{
        name: dataclasses.replace(getattr(cfg, name), **fields)
        for name, fields in sections.items()})


@pytest.fixture(scope="module")
def data():
    mri_v, mri_l = synthetic.make_dataset(0, "mri", 2, 8, 32)
    ct_v, ct_l = synthetic.make_dataset(0, "ct", 2, 8, 32)
    return mri_v, mri_l, ct_v, ct_l


@pytest.fixture(scope="module")
def cfg(tiny_config):
    return _port_cfg(tiny_config)


@pytest.fixture(scope="module")
def src_state(cfg, data):
    return api.train_source(cfg, data[0], data[1], steps=2, device="cpu")


# ------------------------------------------------- twin of tests/test_api.py
def test_three_call_workflow(cfg, data, tmp_path):
    mri_v, mri_l, ct_v, ct_l = data
    cfg = _with(cfg, source={"steps": 6},
                adapt={"steps": 8, "pretrain_steps": 2},
                run={"ckpt_every": 4, "log_every": 0})
    src = api.train_source(cfg, mri_v, mri_l, out_dir=str(tmp_path / "src"),
                           device="cpu")
    assert int(src.step) == 6
    table0 = api.evaluate(cfg, src, ct_v[1:], ct_l[1:])
    assert 0.0 <= table0["mean"]["dice"] <= 1.0

    ad = api.adapt(cfg, src, mri_v, mri_l, ct_v[:1],
                   out_dir=str(tmp_path / "ad"))
    assert int(ad.step) == 10  # 2 pretrain + 8 adapt
    table1 = api.evaluate(cfg, ad, ct_v[1:], ct_l[1:])
    assert "AA" in table1 and "mean" in table1
    # unsupervised class-ratio checkpoint selection ran and persisted
    with open(tmp_path / "ad" / "selection.json") as f:
        rec = json.load(f)
    assert rec["signal"] == "class_ratio"
    assert os.path.exists(tmp_path / "ad" /
                          f"step_{rec['best_step']:08d}.npz")
    assert not os.path.exists(tmp_path / "ad" / "tb")  # the CLI's only

    # resume: calling again with the same out_dir continues from the
    # checkpoint, which here is the end
    before = sorted(os.listdir(tmp_path / "src"))
    src2 = api.train_source(cfg, mri_v, mri_l, out_dir=str(tmp_path / "src"),
                            device="cpu")
    assert int(src2.step) == 6  # already done -> no extra steps
    assert sorted(os.listdir(tmp_path / "src")) == before
    ad2 = api.adapt(cfg, src, mri_v, mri_l, ct_v[:1],
                    out_dir=str(tmp_path / "ad"))
    assert int(ad2.step) == 10


def test_load_config_default_and_file(tmp_path):
    cfg = api.load_config(None)
    assert cfg == tcfg.ExperimentConfig()
    p = tmp_path / "c.json"
    p.write_text(cfg.to_json())
    assert api.load_config(str(p)).segmenter.stages == cfg.segmenter.stages


def test_out_dir_none_writes_nothing(cfg, data, src_state, tmp_path,
                                     monkeypatch):
    mri_v, mri_l, ct_v, _ = data
    monkeypatch.chdir(tmp_path)
    src = api.train_source(_with(cfg, run={"ckpt_every": 1}), mri_v, mri_l,
                           steps=2, device="cpu")
    ad = api.adapt(_with(cfg, run={"ckpt_every": 1}), src_state, mri_v,
                   mri_l, ct_v[:1], steps=4, pretrain_steps=1)
    assert int(src.step) == 2 and int(ad.step) == 5
    assert os.listdir(tmp_path) == []


def test_evaluate_applies_config_postprocess(cfg, data, src_state):
    """api.evaluate honors run.eval_postprocess like the CLI: with 'cc' the
    table carries the raw (unfiltered) table under 'raw'."""
    mri_v, mri_l = data[0][:1], data[1][:1]
    cc = _with(cfg, run={"eval_postprocess": "cc"})
    assert "raw" in api.evaluate(cc, src_state, mri_v, mri_l)
    assert "raw" not in api.evaluate(cc, src_state, mri_v, mri_l,
                                     postprocess="none")
    assert "raw" not in api.evaluate(cfg, src_state, mri_v, mri_l)


@pytest.mark.parametrize("tta", [None, "flip"])
def test_api_predict_matches_eval_forward(cfg, data, src_state, tta):
    """api.predict (serving masks) agrees with the forward evaluate uses,
    also under flip TTA (by argument and by run.eval_tta)."""
    mri_v = data[0][:1]
    preds = api.predict(cfg, src_state, mri_v, postprocess="none", tta=tta)
    assert len(preds) == 1 and preds[0].shape == mri_v[0].shape
    assert preds[0].dtype == np.uint8
    fwd = api._forward_for(cfg, src_state)
    ref = inference.predict_volume(
        inference.tta_flip(fwd) if tta else fwd, mri_v[0],
        context=cfg.data.context_slices, batch_size=cfg.data.batch_size,
        device="cpu")
    np.testing.assert_array_equal(preds[0], ref.astype(np.uint8))
    if tta:
        by_cfg = api.predict(_with(cfg, run={"eval_tta": "flip"}), src_state,
                             mri_v, postprocess="none")
        np.testing.assert_array_equal(by_cfg[0], preds[0])
        table = api.evaluate(cfg, src_state, mri_v, data[1][:1], tta="flip")
        assert 0.0 <= table["mean"]["dice"] <= 1.0


def test_api_eval_bf16_serving_precision(cfg, data, src_state):
    """run.eval_bf16 builds the serving forward at bf16 compute and leaves
    the training dtype alone: masks within 2% of the f32 forward's."""
    mri_v = data[0][:1]
    cfg16 = _with(cfg, run={"eval_bf16": True})
    assert tcfg.eval_view(cfg) is cfg
    assert tcfg.eval_view(cfg16).segmenter.compute_dtype == "bfloat16"
    assert cfg16.segmenter.compute_dtype == cfg.segmenter.compute_dtype
    p32 = api.predict(cfg, src_state, mri_v, postprocess="none")[0]
    p16 = api.predict(cfg16, src_state, mri_v, postprocess="none")[0]
    assert np.mean(p32 != p16) < 0.02


def test_forward_for_takes_the_fused_path_under_use_pallas(
        cfg, data, src_state, monkeypatch):
    """run.use_pallas sends evaluate / predict through the fused conv path
    (the kernel's plain version on CPU tensors), for both state types."""
    mri_v, mri_l, ct_v, _ = data
    calls = []
    real = segmenter.apply_fused_eval

    def spy(*a, **kw):
        calls.append(kw.get("dam_params") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(segmenter, "apply_fused_eval", spy)
    fused = _with(cfg, run={"use_pallas": True})
    ad = adapt.init_state(2, cfg, src_state.params, src_state.bn_state)
    for state, vols in ((src_state, mri_v[:1]), (ad, ct_v[:1])):
        calls.clear()
        plain = api.predict(cfg, state, vols, postprocess="none")[0]
        assert calls == []
        got = api.predict(fused, state, vols, postprocess="none")[0]
        assert calls == [isinstance(state, adapt.AdaptState)] * 2  # 8 slices, batch 4
        assert np.mean(got != plain) < 1e-3


def test_api_smoothed_selection_wiring(cfg, data, src_state, tmp_path):
    """api.adapt with select_smooth_span > 0 streams the smoothed selector
    (adapt.smooth_window ticks), resolves the tail at probe.finalize(), and
    persists the smoothing provenance in selection.json."""
    mri_v, mri_l, ct_v, _ = data
    cfg = _with(cfg, adapt={"steps": 20, "pretrain_steps": 10,
                            "select_every": 5, "select_smooth_span": 15,
                            "select_warmup": 0, "select_policy": "cr"},
                run={"ckpt_every": 10, "log_every": 0})
    ad = api.adapt(cfg, src_state, mri_v, mri_l, ct_v[:1],
                   out_dir=str(tmp_path / "ad"))
    assert int(ad.step) == 30
    with open(tmp_path / "ad" / "selection.json") as f:
        rec = json.load(f)
    assert rec["signal"] == "class_ratio" and rec["policy"] == "cr"
    assert rec["smooth_window"] == 3
    # probes tick at multiples of 5 past pretrain (10): best is one of them
    assert rec["best_step"] % 5 == 0 and rec["best_step"] > 10


# ------------------------------------------------- against the JAX package
@pytest.fixture(scope="module")
def carried(tiny_config, cfg, data):
    """JAX states from mcmda_tpu.api (2 source steps; 2 + 2 adapt steps) and
    the same states in the port, carried across as numpy."""
    mri_v, mri_l, ct_v, _ = data
    jsrc = japi.train_source(tiny_config, mri_v, mri_l, steps=2)
    jad = japi.adapt(tiny_config, jsrc, mri_v, mri_l, ct_v[:1], steps=2,
                     pretrain_steps=2)
    like_src = source.init_state(0, cfg, "cpu")
    like_ad = adapt.init_state(0, cfg, like_src.params, like_src.bn_state)
    out = {}
    for name, jstate, like in (("source", jsrc, like_src),
                               ("adapted", jad, like_ad)):
        flat = {k: np.array(v) for k, v in
                jckpt._flatten(jax.device_get(jstate)).items()}
        out[name] = (jstate, weights.unflatten_state(flat, like))
    assert int(out["adapted"][1].step) == 4
    return out


@pytest.mark.parametrize("pp", ["none", "cc"])
@pytest.mark.parametrize("tta", ["none", "flip"])
@pytest.mark.parametrize("which", ["source", "adapted"])
def test_predict_and_evaluate_match_the_jax_api(tiny_config, cfg, data,
                                                carried, which, tta, pp):
    _, _, ct_v, ct_l = data
    jstate, tstate = carried[which]
    want = japi.predict(tiny_config, jstate, ct_v, postprocess=pp, tta=tta)
    got = api.predict(cfg, tstate, ct_v, postprocess=pp, tta=tta)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert len(np.unique(got[0])) > 1
    jt = japi.evaluate(tiny_config, jstate, ct_v, ct_l, postprocess=pp,
                       tta=tta, spacing=(2.0, 1.0, 1.0))
    tt = api.evaluate(cfg, tstate, ct_v, ct_l, postprocess=pp, tta=tta,
                      spacing=(2.0, 1.0, 1.0))
    assert ("raw" in tt) == ("raw" in jt) == (pp == "cc")
    for name in ("AA", "LAC", "LVC", "MYO", "mean"):
        np.testing.assert_allclose(tt[name]["dice"], jt[name]["dice"],
                                   atol=1e-6, err_msg=name)
        for m in ("assd", "hd95"):
            np.testing.assert_allclose(tt[name][m], jt[name][m], atol=1e-4,
                                       err_msg=f"{name} {m}")
        assert tt[name]["assd_misses"] == jt[name]["assd_misses"]


# --------------------------------------------------- against the port's CLI
_SETS = ("source.steps=5", "adapt.steps=8", "adapt.pretrain_steps=2",
         "run.ckpt_every=4", "run.log_every=1", "data.warp=pallas",
         "segmenter.train_fused=pallas")


@pytest.fixture(scope="module", params=["device-resident", "host-sampler"])
def api_and_cli_runs(request, tiny_config, tmp_path_factory):
    """The same config and seeds through the API and through the CLI, on
    one feed: {"src": (api dir, cli dir), "ad": (api dir, cli dir)}."""
    tmp = tmp_path_factory.mktemp("runs")
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(tiny_config.to_json())
    cfg = tcfg.load_config(str(cfg_path), _SETS)
    # the phantoms of the CLI's --synthetic --synthetic-volumes 2
    mri_v, mri_l = synthetic.make_dataset(0, "mri", 2, 16, 32)
    ct_v, _ = synthetic.make_dataset(0, "ct", 2, 16, 32)
    d = {k: str(tmp / k) for k in ("api_src", "cli_src", "api_ad", "cli_ad")}
    common = ["--config", str(cfg_path), "--synthetic",
              "--synthetic-volumes", "2", "--device", "cpu"]
    for kv in _SETS:
        common += ["--set", kv]
    mp = pytest.MonkeyPatch()
    if request.param == "host-sampler":
        mp.setattr(api, "_ON_DEVICE_BYTES", 0)
    try:
        src = api.train_source(cfg, mri_v, mri_l, out_dir=d["api_src"],
                               device="cpu")
        api.adapt(cfg, src, mri_v, mri_l, ct_v[:-1], out_dir=d["api_ad"])
        assert tcli.main(["train-source", *common, "--out",
                          d["cli_src"]]) == 0
        assert tcli.main(["adapt", *common, "--source-ckpt", d["cli_src"],
                          "--out", d["cli_ad"]]) == 0
    finally:
        mp.undo()
    return {"feed": request.param, "src": (d["api_src"], d["cli_src"]),
            "ad": (d["api_ad"], d["cli_ad"])}


def _losses(run, key):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


@pytest.mark.parametrize("phase,last,key", [("src", 5, "loss"),
                                            ("ad", 10, "d_loss")])
def test_api_and_cli_write_the_same_checkpoints(api_and_cli_runs, phase,
                                                last, key):
    a_dir, c_dir = api_and_cli_runs[phase]
    a_ckpts = sorted(n for n in os.listdir(a_dir) if n.endswith(".npz"))
    assert a_ckpts == sorted(n for n in os.listdir(c_dir)
                             if n.endswith(".npz"))
    assert f"step_{last:08d}.npz" in a_ckpts
    for name in a_ckpts:  # the final one, the kept ones, the selected one
        a = weights.read_npz(os.path.join(a_dir, name))
        c = weights.read_npz(os.path.join(c_dir, name))
        assert set(a) == set(c)
        for k in a:
            assert a[k].dtype == c[k].dtype
            np.testing.assert_array_equal(a[k], c[k], err_msg=f"{name} {k}")
    la, lc = _losses(a_dir, key), _losses(c_dir, key)
    assert la == lc and len(la) == last and np.isfinite(la).all()
    if phase == "ad":
        with open(os.path.join(a_dir, "selection.json")) as f, \
                open(os.path.join(c_dir, "selection.json")) as g:
            assert json.load(f) == json.load(g)


def test_adapt_takes_the_two_sampler_branch(cfg, data, src_state,
                                            monkeypatch):
    """With the cutoff at 0 ``api.adapt`` draws from two host samplers
    seeded +3 / +4 and hands the step {"src_image", "tgt_image"}."""
    mri_v, mri_l, ct_v, _ = data
    seeds, keys = [], []
    real_sampler, real_feed = pipeline.BatchSampler, \
        pipeline.prefetch_to_device

    def sampler(ds, bs, seed=0, num_classes=None):
        seeds.append(seed)
        return real_sampler(ds, bs, seed=seed, num_classes=num_classes)

    def feed(stream, size=2, device="cuda"):
        for b in real_feed(stream, size, device):
            keys.append((sorted(b), str(b["src_image"].device)))
            yield b

    monkeypatch.setattr(api, "_ON_DEVICE_BYTES", 0)
    monkeypatch.setattr(pipeline, "BatchSampler", sampler)
    monkeypatch.setattr(pipeline, "prefetch_to_device", feed)
    ad = api.adapt(cfg, src_state, mri_v, mri_l, ct_v[:1], steps=2,
                   pretrain_steps=1)
    assert int(ad.step) == 3
    assert seeds == [cfg.run.seed + 3, cfg.run.seed + 4]
    assert keys == [(["src_image", "tgt_image"], "cpu")] * 3
    assert all(np.isfinite(v).all()
               for v in weights.flatten_state(ad).values())
