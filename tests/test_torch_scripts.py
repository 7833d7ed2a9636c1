"""The port's quality scripts on the CPU at toy sizes, against the JAX
package's scripts: the e2e example twin, the seed-sweep twin (artifact
keys, cadence, ``--merge`` resume, the probe's ``device_dice`` against the
reference's within 1e-6), the synthetic-benchmark twin (writes only under
its ``--results-dir``), the serving-agreement script and the MMWHS
preprocessing twin (output equal to the reference script's)."""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmda_tpu_torch.scripts import preprocess_mmwhs, seed_sweep, \
    serving_agreement, synthetic_benchmark

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5 = os.path.join(ROOT, "results", "mri2ct_seed_sweep_r5.json")
# keys the reference script writes today beyond the r5 artifact (its
# config-policy pick came after r5), and the port's provenance
NEWER_TOP = {"selected_cfg"}
NEWER_SEED = {"selected_cfg", "selected_cfg_step"}
PROVENANCE = {"card", "settings"}


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    # one intra-op thread: beside the other test workers, a subprocess with
    # a thread per core contends with them for the cores and runs many
    # times slower than alone
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def cfg_dir(tiny_config, tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    for name in ("mri2ct", "ct2mri"):
        (d / f"{name}.json").write_text(tiny_config.to_json())
    return d


# --------------------------------------------------------------- e2e twin
def test_e2e_example_twin_runs(tmp_path):
    """The twin of examples/synthetic_e2e.py runs its five stages on the
    CPU at 30/10/30 steps and prints the summary and the verdict (the
    quality gate is not asked of 30-step runs)."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "mcmda_tpu_torch", "examples",
                                      "synthetic_e2e.py"),
         "--cpu", "--source-steps", "30", "--pretrain-steps", "10",
         "--adapt-steps", "30"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=_env())
    assert out.returncode in (0, 1), out.stderr[-2000:]
    assert "E2E RESULT:" in out.stdout
    assert "summary: MRI dice=" in out.stdout
    for stage in ("config 2", "config 1", "config 3", "config 4",
                  "adapted net on CT"):
        assert f"== {stage}" in out.stdout


def test_e2e_example_twin_refuses_data_parallelism(monkeypatch):
    """``--dp 2`` outside a process group of 2 ranks (no torchrun
    environment) raises; it never trains on one device instead."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    spec = importlib.util.spec_from_file_location(
        "port_e2e", os.path.join(ROOT, "mcmda_tpu_torch", "examples",
                                 "synthetic_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(ValueError, match="process group has 1 rank"):
        mod.main(["--cpu", "--dp", "2", "--source-steps", "1"])


# ------------------------------------------------------------ sweep twin
def _sweep(cfg_dir, out, *extra):
    return seed_sweep.main([
        "--direction", "mri2ct", "--config", str(cfg_dir / "mri2ct.json"),
        "--device", "cpu", "--volumes", "2", "--depth", "16",
        "--source-steps", "3", "--adapt-steps", "6", "--out", str(out),
        *extra])


@pytest.fixture(scope="module")
def sweep(cfg_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep") / "sweep.json"
    art = _sweep(cfg_dir, out, "--seeds", "2", "--eval-every", "2")
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(art))
    return out, art


def test_sweep_artifact_has_the_reference_keys(sweep):
    _, art = sweep
    with open(R5) as f:
        ref = json.load(f)
    assert set(art) == set(ref) | NEWER_TOP | PROVENANCE
    assert art["seeds"] == 2 and [r["seed"] for r in art["per_seed"]] == \
        [0, 1]
    for row in art["per_seed"]:
        assert set(row) == set(ref["per_seed"][0]) | NEWER_SEED
        assert set(row["tta"]) == set(ref["per_seed"][0]["tta"])
        assert set(ref["per_seed"][0]["gap"]) <= set(row["gap"]) <= \
            set(ref["per_seed"][0]["gap"]) | {"tta_cfg"}
    ref_curve = next(iter(ref["curves"].values()))[0]
    for curve in art["curves"].values():
        assert [c["step"] for c in curve] == [2, 4, 6]
        assert all(set(c) == set(ref_curve) for c in curve)
    assert all(0.0 <= art["final"][k] <= 1.0 for k in ("mean", "min"))
    assert set(art["settings"]) == {"tf32", "cudnn_deterministic",
                                    "dispatch", "source_steps",
                                    "adapt_steps", "eval_every",
                                    "source_digest"}
    assert art["settings"]["dispatch"] == {
        "graph": False, "inner_source": 3, "inner_adapt": 2, "donate": True}
    assert (art["settings"]["source_steps"], art["settings"]["adapt_steps"],
            art["settings"]["eval_every"]) == (3, 6, 2)
    assert len(art["settings"]["source_digest"]) == 64
    assert art["card"] is None  # no card on the CPU


def test_sweep_merge_resumes_bitwise(cfg_dir, sweep, tmp_path):
    """``--first-seed 1 --seeds 1 --merge`` keeps seed 0's row and
    reproduces seed 1's, curves included."""
    out, art = sweep
    merged_path = tmp_path / "sweep.json"
    merged_path.write_text(out.read_text())
    merged = _sweep(cfg_dir, merged_path, "--first-seed", "1", "--seeds",
                    "1", "--eval-every", "2", "--merge")
    art = json.loads(json.dumps(art))
    merged = json.loads(json.dumps(merged))
    assert merged["per_seed"] == art["per_seed"]
    assert merged["curves"] == art["curves"]


def test_sweep_merge_refuses_other_overrides(cfg_dir, sweep, tmp_path):
    out, _ = sweep
    path = tmp_path / "sweep.json"
    path.write_text(out.read_text())
    with pytest.raises(SystemExit, match="refuse to merge"):
        _sweep(cfg_dir, path, "--first-seed", "1", "--seeds", "1",
               "--eval-every", "2", "--merge",
               "--set", "adapt.d_acc_cap=0.9")


@pytest.mark.parametrize("key,value", [
    ("source_digest", "0" * 64), ("no_adapt", -1.0)])
def test_sweep_merge_refuses_another_source(cfg_dir, sweep, tmp_path, key,
                                            value):
    """A file whose source state (digest) or no-adapt Dice differs from
    this call's holds rows of another source run: refused, naming it."""
    out, _ = sweep
    prev = json.loads(out.read_text())
    if key == "no_adapt":
        prev[key] = value
    else:
        prev["settings"][key] = value
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(prev))
    with pytest.raises(SystemExit, match=f"refuse to merge.*{key}"):
        _sweep(cfg_dir, path, "--first-seed", "1", "--seeds", "1",
               "--eval-every", "2", "--merge")
    assert json.loads(path.read_text()) == prev


@pytest.mark.parametrize("extra,key", [
    (("--eval-every", "3"), "eval_every"),
    (("--eval-every", "2", "--adapt-steps", "4"), "adapt_steps"),
    (("--eval-every", "2", "--source-steps", "2"), "source_steps")])
def test_sweep_merge_refuses_other_lengths(cfg_dir, sweep, tmp_path, extra,
                                           key):
    """A call at other lengths or another cadence than the file's is
    refused before it trains anything, naming what differs."""
    out, _ = sweep
    path = tmp_path / "sweep.json"
    path.write_text(out.read_text())
    with pytest.raises(SystemExit, match=f"refuse to merge.*{key}"):
        seed_sweep.main([
            "--direction", "mri2ct", "--config",
            str(cfg_dir / "mri2ct.json"), "--device", "cpu", "--volumes",
            "2", "--depth", "16", "--source-steps", "3", "--adapt-steps",
            "6", "--out", str(path), "--first-seed", "1", "--seeds", "1",
            "--merge", *extra])


def test_sweep_carried_source_merges_bitwise(cfg_dir, sweep, tmp_path):
    """A call that saves its source state and a later one that loads it
    (``--save-source`` / ``--source-ckpt``, a sweep split over machines
    that keep no run directory) hold one digest, and the later call's
    seed reproduces the one-call sweep's row and curve bitwise."""
    out, art = sweep
    npz = tmp_path / "source.npz"
    first = _sweep(cfg_dir, tmp_path / "a.json", "--seeds", "1",
                   "--eval-every", "2", "--save-source", str(npz))
    assert first["settings"] == art["settings"]
    path = tmp_path / "b.json"
    path.write_text(json.dumps(first))
    merged = _sweep(cfg_dir, path, "--first-seed", "1", "--seeds", "1",
                    "--eval-every", "2", "--merge", "--source-ckpt",
                    str(npz))
    merged, art = json.loads(json.dumps(merged)), json.loads(json.dumps(art))
    assert merged["settings"] == art["settings"]
    assert merged["per_seed"] == art["per_seed"]
    assert merged["curves"] == art["curves"]
    with pytest.raises(SystemExit, match="holds a source run of 3 steps"):
        _sweep(cfg_dir, tmp_path / "c.json", "--seeds", "1",
               "--source-steps", "4", "--source-ckpt", str(npz))


def test_sweep_cadence_defaults_to_select_every(cfg_dir, tmp_path):
    art = _sweep(cfg_dir, tmp_path / "s.json", "--seeds", "1",
                 "--set", "adapt.select_every=3")
    assert [c["step"] for c in art["curves"][0]] == [3, 6]


def test_source_digest_in_jax_tree_order():
    """The digest hashes the leaves in ``jax.tree_util`` order (dict keys
    sorted at every level), as little-endian f32: a state whose dicts were
    built in another order (a trained BN state is rebuilt in forward
    order) has the same digest, and one changed bit changes it."""
    rng = np.random.default_rng(0)
    params = {"rm2": {"w": rng.normal(size=(3, 3, 2, 4)),
                      "b": rng.normal(size=4)},
              "rm1": {"conv": {"w": rng.normal(size=(2, 5))}}}
    bn = {"rm2": {"var": rng.uniform(size=4), "mean": rng.normal(size=4)}}
    params = jax.tree_util.tree_map(lambda x: x.astype(np.float32), params)
    bn = jax.tree_util.tree_map(lambda x: x.astype(np.float32), bn)
    leaves = jax.tree_util.tree_leaves(params) + jax.tree_util.tree_leaves(bn)
    want = hashlib.sha256(np.concatenate(
        [x.ravel() for x in leaves]).astype("<f4").tobytes()).hexdigest()

    def to_torch(tree, reverse=False):
        if isinstance(tree, dict):
            keys = sorted(tree, reverse=reverse)
            return {k: to_torch(tree[k], reverse) for k in keys}
        return torch.from_numpy(tree.copy())

    assert seed_sweep.source_digest(to_torch(params), to_torch(bn)) == want
    assert seed_sweep.source_digest(to_torch(params, True),
                                    to_torch(bn, True)) == want
    flipped = to_torch(bn)
    flipped["rm2"]["var"][0] = float(np.nextafter(bn["rm2"]["var"][0],
                                                  np.float32(2)))
    assert seed_sweep.source_digest(to_torch(params), flipped) != want


def _reference_sweep_module():
    spec = importlib.util.spec_from_file_location(
        "ref_seed_sweep", os.path.join(ROOT, "scripts", "seed_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_dice_matches_the_reference():
    """Same stacks, labels (with -1 padding rows) and forward: the
    intersection and predicted counts equal, the mean entropy within
    1e-6.  The logits are small integers (exact in f32), so both argmaxes
    see identical values."""
    ref = _reference_sweep_module()
    rng = np.random.default_rng(0)
    k, b, h, w, ctx, nc = 3, 4, 8, 8, 3, 5
    stacks = rng.integers(-2, 3, (k, b, h, w, ctx)).astype(np.float32)
    weight = rng.integers(-2, 3, (ctx, nc)).astype(np.float32)
    labels = rng.integers(0, nc, (k * b, h, w)).astype(np.int32)
    labels[-3:] = -1  # padding rows
    sums = np.bincount(labels[labels >= 0], minlength=nc).astype(np.float32)

    def jfwd(_state, xb):
        return jax.nn.softmax(jnp.einsum("bhwc,ck->bhwk", xb, weight), -1)

    def tfwd(_state, xb):
        return torch.softmax(torch.einsum("bhwc,ck->bhwk", xb,
                                          torch.from_numpy(weight)), -1)

    j = ref.device_dice(None, jnp.asarray(stacks), jnp.asarray(sums),
                        jnp.asarray(labels), jfwd, nc)
    t = seed_sweep.device_dice(None, torch.from_numpy(stacks),
                               torch.from_numpy(sums),
                               torch.from_numpy(labels.astype(np.int64)),
                               tfwd, nc)
    for a, bb in zip(j, t):
        np.testing.assert_allclose(np.asarray(a), bb.numpy(), rtol=0,
                                   atol=1e-6)


# -------------------------------------------------------- benchmark twin
def test_benchmark_twin_writes_only_under_its_results_dir(cfg_dir,
                                                          tmp_path, capsys):
    results = os.path.join(ROOT, "results")
    before = {n: os.path.getmtime(os.path.join(results, n))
              for n in os.listdir(results)}
    res = tmp_path / "res"
    assert synthetic_benchmark.main([
        "--runs", str(tmp_path / "runs"), "--results-dir", str(res),
        "--config-dir", str(cfg_dir), "--device", "cpu",
        "--set", "source.steps=3", "--set", "adapt.steps=3",
        "--set", "run.ckpt_every=0", "--set", "run.use_pallas=true"]) == 0
    assert sorted(os.listdir(res)) == sorted(
        f"torch_synthetic_{d}_{k}.json" for d in ("mri2ct", "ct2mri")
        for k in ("no_adapt", "adapted"))
    for name in os.listdir(res):
        with open(res / name) as f:
            table = json.load(f)
        assert 0.0 <= table["mean"]["dice"] <= 1.0
    after = {n: os.path.getmtime(os.path.join(results, n))
             for n in os.listdir(results)}
    assert after == before
    out = capsys.readouterr().out
    assert "== synthetic benchmark tables ==" in out
    assert "mri2ct adapted   mean dice" in out


def test_serving_agreement_on_the_cpu(cfg_dir, tmp_path):
    """On CPU tensors both serving paths are the plain version: the
    script reports full agreement in bf16 and f32 on a trained run."""
    run = tmp_path / "runs"
    synthetic_benchmark.main([
        "--runs", str(run), "--results-dir", str(tmp_path / "res"),
        "--config-dir", str(cfg_dir), "--device", "cpu", "--direction",
        "mri2ct", "--set", "source.steps=2", "--set", "adapt.steps=2",
        "--set", "run.ckpt_every=0"])
    out = serving_agreement.main([
        "--config", str(cfg_dir / "mri2ct.json"), "--ckpt",
        str(run / "mri2ct" / "adapt"), "--device", "cpu",
        "--synthetic-volumes", "2", "--json-out", str(tmp_path / "a.json")])
    for prec in ("bf16", "f32"):
        assert out[prec]["served"]["agreement"] == 1.0
        assert out[prec]["raw"]["differ"] == 0
        assert out[prec]["served"]["voxels"] == 16 * 32 * 32
    assert json.loads((tmp_path / "a.json").read_text())["f32"] == out["f32"]


# ---------------------------------------------------- preprocessing twin
def test_preprocess_twin_equals_the_reference(tmp_path):
    """Both scripts on the same raw MMWHS-style files (an MRI pair and a
    CT image without labels) write the same npz files, array for array."""
    sys.path.insert(0, ROOT)
    from tests.test_data import _write_nifti

    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(0)
    img = rng.normal(size=(12, 10, 6)).astype(np.float32)
    lab = np.zeros((12, 10, 6), np.float32)
    lab[4:8, 4:8, 2:4] = 500   # LVC
    lab[2:4, 2:4, 1:3] = 820   # AA
    lab[0:2, 6:9, 0:2] = 205   # MYO
    _write_nifti(str(raw / "mr_train_1001_image.nii.gz"), img)
    _write_nifti(str(raw / "mr_train_1001_label.nii.gz"), lab)
    _write_nifti(str(raw / "ct_train_2001_image.nii.gz"), img * 3.0 + 1.0)

    ref_out, port_out = tmp_path / "ref", tmp_path / "port"
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "scripts", "preprocess_mmwhs.py"),
                        "--raw", str(raw), "--out", str(ref_out),
                        "--size", "8"],
                       capture_output=True, text=True, env=_env())
    assert r.returncode == 0, r.stderr
    preprocess_mmwhs.main(["--raw", str(raw), "--out", str(port_out),
                           "--size", "8"])
    files = sorted(os.path.relpath(os.path.join(d, f), ref_out)
                   for d, _, fs in os.walk(ref_out) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), port_out)
                           for d, _, fs in os.walk(port_out) for f in fs)
    assert len(files) == 3
    for rel in files:
        with np.load(ref_out / rel) as a, np.load(port_out / rel) as b:
            assert a.files == b.files
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
