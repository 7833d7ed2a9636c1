"""``train-source -> adapt -> evaluate -> predict`` through the port's CLI on
the CPU at a tiny config, and the adapt checkpoints across both packages:
the JAX package's ``evaluate`` reads the port's adapt run, and the port's
``adapt`` resumes the JAX package's."""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from mcmda_tpu import cli as jcli
from mcmda_tpu import config as jcfg
from mcmda_tpu.train import adapt as jadapt
from mcmda_tpu.train import source as jsource
from mcmda_tpu.utils import checkpoint as jckpt
from mcmda_tpu_torch import cli as tcli
from mcmda_tpu_torch.data import synthetic, volumes


def _common(tiny_config, tmp_path):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(tiny_config.to_json())
    return ["--config", str(cfg_path), "--synthetic",
            "--synthetic-volumes", "2", "--set", "run.log_every=1"]


def _port(argv):
    return tcli.main([argv[0], *argv[1:], "--device", "cpu"])


@pytest.fixture(scope="module")
def source_run(tiny_config, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("src")
    common = _common(tiny_config, tmp)
    out = str(tmp / "src")
    assert _port(["train-source", *common, "--set", "source.steps=4",
                  "--set", "run.ckpt_every=0", "--out", out]) == 0
    return common, out


def _metrics(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_adapt_evaluate_predict(source_run, tmp_path):
    """adapt writes selection.json (class-ratio signal), materializes the
    selected checkpoint, writes snapshot PNGs and logs both selection
    signals; evaluate and predict resolve the run directory through it; the
    JAX package's evaluate reads the same run."""
    from PIL import Image

    common, src = source_run
    out = str(tmp_path / "adapt")
    sets = ["--set", "adapt.steps=8", "--set", "adapt.pretrain_steps=2",
            "--set", "run.ckpt_every=4", "--set", "data.warp=pallas"]
    assert _port(["adapt", *common, *sets, "--source-ckpt", src,
                  "--out", out]) == 0
    with open(os.path.join(out, "selection.json")) as f:
        rec = json.load(f)
    assert rec["signal"] == "class_ratio" and rec["policy"] == "cr_ent"
    assert 2 < rec["best_step"] <= 10
    assert os.path.exists(os.path.join(out,
                                       f"step_{rec['best_step']:08d}.npz"))
    assert os.path.exists(os.path.join(out, "step_00000010.npz"))
    recs = _metrics(out)
    assert [r["step"] for r in recs if "g_loss" in r] == list(range(2, 10))
    assert [r["step"] for r in recs if "d_loss" in r] == list(range(10))
    assert {"class_ratio_dist", "equilibrium_dist", "probe_entropy"} <= \
        set().union(*recs)
    assert all(np.isfinite(r["d_loss"]) for r in recs if "d_loss" in r)
    snaps = sorted(os.listdir(os.path.join(out, "snapshots")))
    assert snaps == ["step_00000004.png", "step_00000008.png"]
    img = np.asarray(Image.open(os.path.join(out, "snapshots", snaps[0])))
    assert img.shape == (4 * 32, 2 * 32, 3)

    got = tcli.main(["evaluate", *common, "--ckpt", out, "--device", "cpu",
                     "--json-out", str(tmp_path / "eval.json")])
    assert got == 0
    with open(tmp_path / "eval.json") as f:
        agg = json.load(f)
    assert np.isfinite(agg["mean"]["dice"]) and "per_volume" in agg
    # the JAX package's evaluate on the port's run: the same table
    jcli.main(["evaluate", *common, "--ckpt", out,
               "--json-out", str(tmp_path / "jeval.json")])
    with open(tmp_path / "jeval.json") as f:
        jagg = json.load(f)
    for name in ("AA", "LAC", "LVC", "MYO", "mean"):
        np.testing.assert_allclose(agg[name]["dice"], jagg[name]["dice"],
                                   atol=0.02, err_msg=name)

    v, _ = synthetic.make_volume(np.random.default_rng(0), "ct", depth=5,
                                 size=32)
    volumes.save_volume(str(tmp_path / "v.npz"), v)
    pred = str(tmp_path / "pred")
    assert _port(["predict", "--config", common[1], "--ckpt", out,
                  "--input", str(tmp_path / "v.npz"), "--out", pred]) == 0
    mask = volumes.load_volume_with_spacing(
        os.path.join(pred, "v_pred.npz"))[0]
    assert mask.shape == (5, 32, 32)
    assert tcli._resolve_ckpt(out).endswith(f"step_{rec['best_step']:08d}")


def test_adapt_dam_ema_selects_a_variant(source_run, tmp_path):
    """With weight averaging on, the probe scores both variants,
    selection.json records the winner and evaluate --weights auto runs."""
    common, src = source_run
    out = str(tmp_path / "adapt")
    sets = ["--set", "adapt.steps=8", "--set", "adapt.dam_ema=0.7",
            "--set", "run.ckpt_every=4"]
    assert _port(["adapt", *common, *sets, "--source-ckpt", src,
                  "--out", out]) == 0
    with open(os.path.join(out, "selection.json")) as f:
        assert json.load(f)["weights"] in ("live", "avg")
    assert {"class_ratio_dist", "class_ratio_dist_avg"} <= \
        set().union(*_metrics(out))
    assert tcli.main(["evaluate", *common, "--set", "adapt.dam_ema=0.7",
                      "--ckpt", out, "--device", "cpu"]) is not None


def test_port_resumes_jax_adapt_run(source_run, tmp_path):
    """The JAX package's adapt CLI runs 4 steps from the port's source
    checkpoint; the port's adapt resumes that run directory at step 4 and
    finishes it."""
    common, src = source_run
    out = str(tmp_path / "adapt")
    jcli.main(["adapt", *common, "--set", "adapt.steps=4",
               "--set", "run.ckpt_every=0", "--set", "run.donate=false",
               "--source-ckpt", src, "--out", out])
    # the JAX package's saves are orbax directories unless multi-process;
    # re-save its last step as npz, which the port reads
    step4 = os.path.join(out, "step_00000004")
    if os.path.isdir(step4):
        with open(common[1]) as f:
            cfg = jcfg.ExperimentConfig.from_json(f.read())
        s = jsource.init_state(jax.random.key(0), cfg)
        like = jadapt.init_state(jax.random.key(1), cfg, s.params,
                                 s.bn_state)
        state = jckpt.restore(step4, like)
        np.savez(step4 + ".npz", **jckpt._flatten(state))
        shutil.rmtree(step4)
    assert _port(["adapt", *common, "--set", "adapt.steps=6",
                  "--set", "run.ckpt_every=0", "--source-ckpt", src,
                  "--out", out]) == 0
    steps = [r["step"] for r in _metrics(out) if "g_loss" in r]
    assert steps[-2:] == [4, 5]
    assert os.path.exists(os.path.join(out, "step_00000006.npz"))
