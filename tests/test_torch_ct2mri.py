"""The reverse direction (``--direction ct2mri``) through the port's CLI on
the CPU, against the JAX package's CLI, at the tests' tiny config with the
fields in which ``configs/ct2mri.json`` differs from ``mri2ct.json``: the
DAM plugged at rm2, the critic throttled at d_acc 0.9, a selection probe
every 2 steps and flip TTA at evaluation (plus its largest-component
post-processing).

- the synthetic data of ``--direction ct2mri`` (CT source, MRI target, the
  last quarter held out) equals the JAX CLI's bitwise;
- ``train-source -> adapt -> evaluate -> predict`` runs, writes
  ``selection.json`` and the pick, and probes at the JAX CLI's cadence;
- the JAX CLI's ``evaluate`` of the port's run gives the port's table
  (Dice and ASSD within 1e-4 in f32); under the shipped bf16 serving both
  packages' ``predict`` masks agree on at least 99.5% of voxels (bf16
  rounding flips are allowed, f32 is held tightly);
- the port evaluates and resumes a JAX ct2mri adapt run (orbax);
- with ``adapt.dam_ema=0.5`` both packages pick a weight variant and write
  the same selection format.
"""

import argparse
import json
import os

import jax
import numpy as np
import pytest
import torch

from mcmda_tpu import cli as jcli
from mcmda_tpu_torch import cli as tcli, config as tconfig
from mcmda_tpu_torch.data import volumes

# configs/ct2mri.json's fields beside mri2ct.json's, at the cadence of a
# short run
CT2MRI = ["adapt.plug_depth=rm2", "adapt.d_acc_cap=0.9",
          "adapt.select_every=2", "run.eval_tta=flip",
          "run.eval_postprocess=cc"]
F32 = ["--set", "run.eval_bf16=false"]
BF16 = ["--set", "run.eval_bf16=true"]
ADAPT_STEPS = 8
# JAX's adapt donates its buffers by default; the CPU test keeps them
JAX_ONLY = ["--set", "run.donate=false"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: faster at these tiny shapes, and it leaves the
    cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metrics(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _probe_steps(run):
    return [r["step"] for r in _metrics(run) if "class_ratio_dist" in r]


def _port(argv):
    return tcli.main([*argv, "--device", "cpu"])


@pytest.fixture(scope="module")
def runs(tiny_config, tmp_path_factory):
    """A port source run on CT; from it a port and a JAX adapt run of
    ADAPT_STEPS steps."""
    tmp = tmp_path_factory.mktemp("ct2mri")
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(tiny_config.to_json())
    common = ["--config", str(cfg_path), "--direction", "ct2mri",
              "--synthetic", "--synthetic-volumes", "4",
              *(a for kv in CT2MRI for a in ("--set", kv)),
              "--set", "run.log_every=1", "--set", "run.ckpt_every=0"]
    src = str(tmp / "src")
    assert _port(["train-source", *common, "--set", "source.steps=4",
                  "--out", src]) == 0
    adapt = ["adapt", *common, "--set", f"adapt.steps={ADAPT_STEPS}",
             "--source-ckpt", src]
    port_ad, jax_ad = str(tmp / "port_ad"), str(tmp / "jax_ad")
    assert _port([*adapt, "--out", port_ad]) == 0
    jcli.main([*adapt, *JAX_ONLY, "--out", jax_ad])
    return {"tmp": tmp, "common": common, "src": src, "adapt": adapt,
            "port_ad": port_ad, "jax_ad": jax_ad}


def _test_volume(runs):
    """The held-out MRI test volume, saved for ``predict``."""
    path = runs["tmp"] / "test.npz"
    if not path.exists():
        args = tcli.build_parser().parse_args(
            ["evaluate", *runs["common"], "--ckpt", runs["port_ad"]])
        cfg = tconfig.load_config(args.config, args.set)
        (vol,), _ = tcli._get_data(args, cfg)[2]
        volumes.save_volume(str(path), vol)
    return str(path)


@pytest.mark.parametrize("n_volumes", [2, 4])
def test_synthetic_data_equals_the_jax_cli(tiny_config, n_volumes):
    args = argparse.Namespace(synthetic=True, direction="ct2mri",
                              synthetic_volumes=n_volumes, data_root=None,
                              cmd="adapt")
    (t_sv, t_sl), t_tv, (t_xv, t_xl) = tcli._get_data(args, tiny_config)
    (j_sv, j_sl), j_tv, (j_xv, j_xl) = jcli._get_data(args, tiny_config,
                                                      "ct2mri")
    n_test = max(1, n_volumes // 4)
    assert len(t_sv) == n_volumes and len(t_tv) == n_volumes - n_test
    assert len(t_xv) == n_test
    for got, want in ((t_sv, j_sv), (t_sl, j_sl), (t_tv, j_tv),
                      (t_xv, j_xv), (t_xl, j_xl)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    # CT labelled source, MRI target: the domains of mri2ct swapped
    rev = argparse.Namespace(**{**vars(args), "direction": "mri2ct"})
    (m_sv, _), m_tv, _ = tcli._get_data(rev, tiny_config)
    np.testing.assert_array_equal(t_sv[0], m_tv[0])
    np.testing.assert_array_equal(t_tv[0], m_sv[0])


def test_ct2mri_cli_run(runs):
    """adapt writes selection.json and materializes its pick, probes at the
    JAX CLI's cadence (``min(select_every, steps // 4)`` from the first
    step), logs the throttled critic and the DAM; evaluate and predict
    resolve the run directory through the pick."""
    out = runs["port_ad"]
    with open(os.path.join(out, "selection.json")) as f:
        rec = json.load(f)
    assert rec["signal"] == "class_ratio" and rec["policy"] == "cr_ent"
    best = rec["best_step"]
    assert os.path.exists(os.path.join(out, f"step_{best:08d}.npz"))
    assert os.path.exists(os.path.join(out,
                                       f"step_{ADAPT_STEPS:08d}.npz"))
    assert _probe_steps(out) == _probe_steps(runs["jax_ad"]) == \
        list(range(2, ADAPT_STEPS + 1, 2))
    recs = [r for r in _metrics(out) if "g_loss" in r]
    assert [r["step"] for r in recs] == list(range(ADAPT_STEPS))
    assert all(np.isfinite([r["d_loss"], r["g_loss"], r["d_acc"]]).all()
               for r in recs)
    assert tcli._resolve_ckpt(out).endswith(f"step_{best:08d}")

    res = runs["tmp"] / "port_eval.json"
    assert _port(["evaluate", *runs["common"], "--ckpt", out,
                  "--json-out", str(res)]) == 0
    agg = json.loads(res.read_text())
    assert "raw" in agg and np.isfinite(agg["mean"]["dice"])
    pred = runs["tmp"] / "pred_cli"
    assert _port(["predict", "--config", runs["common"][1],
                  *(a for kv in CT2MRI for a in ("--set", kv)),
                  "--ckpt", out, "--input", _test_volume(runs),
                  "--out", str(pred)]) == 0
    mask = volumes.load_volume_with_spacing(
        str(pred / "test_pred.npz"))[0]
    assert mask.shape == (16, 32, 32)
    assert set(np.unique(mask).tolist()) <= set(range(5))


def _tables_agree(a, b):
    for name in ("AA", "LAC", "LVC", "MYO", "mean"):
        np.testing.assert_allclose(a[name]["dice"], b[name]["dice"],
                                   rtol=0, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(a[name]["assd"], b[name]["assd"],
                                   rtol=0, atol=1e-4, err_msg=name)


def _evaluate_both(runs, ckpt, tag, extra=()):
    """(port table, JAX table) of ``evaluate --ckpt ckpt`` in f32."""
    t, j = runs["tmp"] / f"{tag}_t.json", runs["tmp"] / f"{tag}_j.json"
    argv = ["evaluate", *runs["common"], *F32, *extra, "--ckpt", ckpt]
    assert _port([*argv, "--json-out", str(t)]) == 0
    jcli.main([*argv, "--json-out", str(j)])
    return json.loads(t.read_text()), json.loads(j.read_text())


def _predict_both(runs, prec, jax_main=jcli.main):
    """{package: served mask} of both CLIs' ``predict`` of the port's run
    on the held-out volume, in ``prec`` (the set of --set arguments)."""
    vol = _test_volume(runs)
    masks = {}
    for name, main in (("port", _port), ("jax", jax_main)):
        out = runs["tmp"] / f"pred_{name}_{prec[-1]}"
        main(["predict", "--config", runs["common"][1],
              *(a for kv in CT2MRI for a in ("--set", kv)), *prec,
              "--ckpt", runs["port_ad"], "--input", vol, "--out", str(out)])
        masks[name] = volumes.load_volume_with_spacing(
            str(out / "test_pred.npz"))[0]
    assert masks["port"].shape == masks["jax"].shape == (16, 32, 32)
    return masks


def _jax_op_by_op(argv):
    with jax.disable_jit():
        return jcli.main(argv)


def test_jax_evaluate_of_the_port_run(runs):
    """f32: the two packages' tables within 1e-4 (Dice and ASSD, raw and
    post-processed) and their served masks equal; the shipped bf16: both
    packages' served masks agree on at least 99.5% of voxels.  The JAX CLI
    runs op by op there (``jax.disable_jit``), rounding to bf16 after every
    op as PyTorch does: compiled, XLA keeps f32 inside its fusions, and at
    this size 0.6% of the voxels (near-ties of a barely trained net) land
    on the other side."""
    got, want = _evaluate_both(runs, runs["port_ad"], "port_run")
    _tables_agree(got, want)
    _tables_agree(got["raw"], want["raw"])
    masks = _predict_both(runs, F32)
    np.testing.assert_array_equal(masks["port"], masks["jax"])
    masks = _predict_both(runs, BF16, _jax_op_by_op)
    assert (masks["port"] == masks["jax"]).mean() >= 0.995


def test_port_evaluates_and_resumes_a_jax_run(runs):
    """The JAX CLI's ct2mri adapt run (orbax step directories, its own
    selection.json): the port resolves its pick and evaluates it as the
    JAX CLI does (f32, within 1e-4), then resumes the run at its last step
    and finishes two more."""
    out = runs["jax_ad"]
    with open(os.path.join(out, "selection.json")) as f:
        best = json.load(f)["best_step"]
    assert tcli._resolve_ckpt(out).endswith(f"step_{best:08d}")
    got, want = _evaluate_both(runs, out, "jax_run")
    _tables_agree(got, want)
    steps = ADAPT_STEPS + 2
    assert _port([*runs["adapt"], "--set", f"adapt.steps={steps}",
                  "--out", out]) == 0
    g_steps = [r["step"] for r in _metrics(out) if "g_loss" in r]
    assert g_steps[-3:] == [ADAPT_STEPS - 1, ADAPT_STEPS, ADAPT_STEPS + 1]
    assert os.path.exists(os.path.join(out, f"step_{steps:08d}.npz"))


def test_dam_ema_selects_a_variant_in_both_formats(runs):
    """adapt.dam_ema=0.5: the probe scores the live and the averaged DAM,
    and both packages' selection.json have the same keys and name a
    variant; the JAX CLI evaluates the port's pick as the port does."""
    ema = ["--set", "adapt.dam_ema=0.5"]
    port_out = str(runs["tmp"] / "port_ema")
    jax_out = str(runs["tmp"] / "jax_ema")
    assert _port([*runs["adapt"], *ema, "--out", port_out]) == 0
    jcli.main([*runs["adapt"], *ema, *JAX_ONLY, "--out", jax_out])
    recs = {}
    for name, out in (("port", port_out), ("jax", jax_out)):
        with open(os.path.join(out, "selection.json")) as f:
            recs[name] = json.load(f)
        assert recs[name]["weights"] in ("live", "avg")
        assert "class_ratio_dist_avg" in set().union(*_metrics(out))
    assert set(recs["port"]) == set(recs["jax"])
    assert {c["variant"] for c in recs["port"]["reservoir"]} <= \
        {"live", "avg"}
    got, want = _evaluate_both(runs, port_out, "ema", ema)
    _tables_agree(got, want)
