"""The port's remaining script twins on the CPU at toy sizes: the
plug-depth ablation (its no-adapt Dice on a JAX source state carried across
against ``mcmda_tpu.evaluation.report.evaluate_volumes`` within 1e-4; every
depth at toy steps with the reference's lines), the MMWHS recipe's command
lines under the port's parser, and the reference's numpy-only selection
analyses on a sweep artifact the port's ``seed_sweep.py`` wrote."""

import os
import re
import shlex
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mcmda_tpu import api as japi
from mcmda_tpu.evaluation import report as jreport
from mcmda_tpu.train import source as jsource
from mcmda_tpu.utils import checkpoint as jckpt
from mcmda_tpu_torch import cli as tcli, config as tcfg, weights
from mcmda_tpu_torch.scripts import ablate_plug_depth, seed_sweep
from mcmda_tpu_torch.train import source as tsource

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "mcmda_tpu_torch", "examples",
                      "mmwhs_benchmark.sh")
REF_RECIPE = os.path.join(ROOT, "examples", "mmwhs_benchmark.sh")
DEPTH_LINE = re.compile(r"plug_depth=(rm\d): adapted CT mean Dice "
                        r"(\d\.\d{3}) \(gain [+-]\d\.\d{3}\)")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: faster at these tiny shapes, and it leaves the
    cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_no_adapt_dice_matches_the_reference(tiny_config, capsys):
    """``run`` with no depth: the no-adapt Dice of a JAX source state (3
    steps of ``mcmda_tpu.api.train_source``), carried across, equals the
    reference's evaluate_volumes on the same phantoms within 1e-4."""
    data = ablate_plug_depth.make_data(size=32, depth=16)
    mri_v, mri_l, ct_v, ct_l = data
    jstate = japi.train_source(tiny_config, mri_v[:3], mri_l[:3], steps=3)
    fwd = jax.jit(lambda img: jsource.make_eval_forward(tiny_config)(
        jstate.params, jstate.bn_state, img))
    want = jreport.evaluate_volumes(fwd, ct_v[3:], ct_l[3:],
                                    batch_size=8)["mean"]["dice"]
    cfg = tcfg.ExperimentConfig.from_json(tiny_config.to_json())
    flat = {k: np.array(v) for k, v in
            jckpt._flatten(jax.device_get(jstate)).items()}
    port = weights.unflatten_state(flat, tsource.init_state(0, cfg, "cpu"))
    got, results = ablate_plug_depth.run(cfg, port, (), data)
    assert results == {} and 0.0 < want < 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert capsys.readouterr().out.splitlines() == [
        f"no-adapt CT mean Dice: {got:.3f}"]


def test_every_depth_at_toy_steps(capsys):
    """The command line at toy steps: one line per depth in the reference
    script's format, and the best depth named."""
    assert ablate_plug_depth.main([
        "--device", "cpu", "--source-steps", "3", "--pretrain-steps", "1",
        "--adapt-steps", "2"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 5, lines
    assert re.fullmatch(r"no-adapt CT mean Dice: \d\.\d{3}", lines[0])
    depths = [DEPTH_LINE.fullmatch(ln) for ln in lines[1:4]]
    assert [m.group(1) for m in depths] == ["rm1", "rm2", "rm3"]
    best = max(depths, key=lambda m: float(m.group(2)))
    assert lines[4] == f"best depth: {best.group(1)} ({best.group(2)})"


def test_ablation_config_is_the_smoke_config():
    cfg = ablate_plug_depth.build_config(7, 5, 2)
    ref = tcfg.load_config(os.path.join(ROOT, "configs", "smoke.json"))
    assert (cfg.source.steps, cfg.adapt.steps, cfg.adapt.pretrain_steps) == \
        (7, 5, 2)
    assert cfg.segmenter == ref.segmenter and cfg.data == ref.data
    assert cfg.critic == ref.critic
    assert cfg.data.slice_size == ablate_plug_depth.SIZE == 64


def test_ablation_refuses_a_missing_gpu():
    """``--device`` defaults to cuda: without a GPU that is an error, never
    a run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        ablate_plug_depth.main(["--source-steps", "1", "--depths", "rm2"])


def _commands(path, prefix):
    """The argument lists of every ``<prefix> ...`` line of a recipe, its
    backslash continuations joined."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    n = len(prefix.split())
    return [shlex.split(ln)[n:] for ln in text.splitlines()
            if ln.startswith(prefix + " ")]


def test_mmwhs_recipe_parses_under_the_port_cli():
    """The twin of examples/mmwhs_benchmark.sh: the reference's seven
    commands in the same order and directions, each parsing under the
    port's parser, with ``--device`` passed through and outputs under the
    twin's own names."""
    port = _commands(RECIPE, "python -m mcmda_tpu_torch")
    ref = _commands(REF_RECIPE, "python -m mcmda_tpu")
    assert [c[0] for c in port] == [c[0] for c in ref]
    assert len(port) == 7
    with open(RECIPE) as f:
        assert "OUT=${OUT:-runs/torch_mri2ct}" in f.read().splitlines()
    parser = tcli.build_parser()
    for argv, ref_argv in zip(port, ref):
        args = vars(parser.parse_args(argv))
        ref_args = vars(parser.parse_args(ref_argv))
        assert args["device"] == "$DEVICE"
        for key in ("cmd", "direction", "config", "data_root",
                    "source_only"):
            assert args.get(key) == ref_args.get(key), key
        for key in ("out", "json_out"):
            if args.get(key):
                assert args[key].startswith("$OUT/") or \
                    "torch_" in args[key], args[key]
    pre = _commands(RECIPE, "python -m mcmda_tpu_torch.scripts."
                            "preprocess_mmwhs")
    assert pre == [["--raw", "$RAW", "--out", "$DATA"]]
    r = subprocess.run(["bash", "-n", RECIPE], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr


def test_reference_analyses_read_a_port_sweep_artifact(tiny_config,
                                                       tmp_path):
    """The reference's numpy-only ``analyze_selection.py`` and
    ``policy_search.py`` exit 0 on the port's sweep artifact, with a probe
    tick at their 500-step warm-up."""
    cfg = tmp_path / "ct2mri.json"
    cfg.write_text(tiny_config.to_json())
    out = tmp_path / "sweep.json"
    seed_sweep.main([
        "--direction", "ct2mri", "--config", str(cfg), "--device", "cpu",
        "--seeds", "1", "--volumes", "2", "--depth", "16",
        "--source-steps", "2", "--adapt-steps", "500", "--eval-every", "250",
        "--out", str(out)])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, want in (("analyze_selection.py", "cr_ent (shipped)"),
                         ("policy_search.py", "== ct2mri: 1 seeds")):
        r = subprocess.run([sys.executable,
                            os.path.join(ROOT, "scripts", script), str(out)],
                           capture_output=True, text=True, timeout=120,
                           env=env)
        assert r.returncode == 0, r.stderr[-2000:]
        assert want in r.stdout, r.stdout
