"""The port's orbax reader (``mcmda_tpu_torch/utils/orbax_read.py``)
against checkpoints the JAX package saves with orbax, on the CPU.

The JAX package saves a ``SourceState`` and an ``AdaptState`` whose every
leaf is filled from a seeded numpy stream (so a swapped leaf shows) with
its own ``checkpoint.save(..., block=True)``; the port restores both from
the orbax directory bitwise, leaf for leaf, optimizer state included.  The
port's CLI resumes a JAX orbax run directory at its step, and ``--ckpt``
serves one.  With ``tensorstore`` hidden a directory raises the reader's
error with the one-line npz conversion.
"""

import json
import os
import sys
import warnings

import jax
import numpy as np
import pytest

from mcmda_tpu.train import adapt as jadapt
from mcmda_tpu.train import source as jsource
from mcmda_tpu.utils import checkpoint as jckpt
from mcmda_tpu_torch import cli as tcli
from mcmda_tpu_torch import config as tcfg
from mcmda_tpu_torch import weights
from mcmda_tpu_torch.train import adapt, loop, source
from mcmda_tpu_torch.utils import checkpoint, orbax_read

pytest.importorskip("tensorstore")


def _port_cfg(cfg):
    return tcfg.ExperimentConfig.from_json(cfg.to_json())


def _filled(state, seed):
    """``state`` with every leaf drawn from one seeded numpy stream, in its
    own shape and dtype (positive, so BN variances and Adam's second
    moments stay valid)."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return rng.integers(1, 1000, x.shape).astype(x.dtype)
        return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
    return jax.tree.map(fill, state)


def _jax_states(cfg):
    s = jsource.init_state(jax.random.key(0), cfg)
    a = jadapt.init_state(jax.random.key(1), cfg, s.params, s.bn_state)
    return _filled(s, 1), _filled(a, 2)


def _assert_bitwise(port_state, jax_state):
    want = jckpt._flatten(jax_state)
    got = weights.flatten_state(port_state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def saved(tiny_config, tmp_path_factory):
    """A JAX source run dir (orbax step 4) and adapt run dir (orbax step
    6), each saved by the JAX package."""
    tmp = tmp_path_factory.mktemp("orbax")
    js, ja = _jax_states(tiny_config)
    src = jckpt.save(str(tmp / "src"), js, step=4, block=True)
    ada = jckpt.save(str(tmp / "adapt"), ja, step=6, block=True)
    assert os.path.isdir(src) and os.path.isdir(ada)
    return tmp, js, ja


def _port_states(tiny_config):
    cfg = _port_cfg(tiny_config)
    s = source.init_state(0, cfg, "cpu")
    return s, adapt.init_state(2, cfg, s.params, s.bn_state)


def test_source_and_adapt_states_restore_bitwise(tiny_config, saved):
    tmp, js, ja = saved
    like_s, like_a = _port_states(tiny_config)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no leaf may fall back to init
        s = checkpoint.restore(str(tmp / "src" / "step_00000004"), like_s)
        a = checkpoint.restore(str(tmp / "adapt" / "step_00000006"), like_a)
    _assert_bitwise(s, js)
    _assert_bitwise(a, ja)
    assert int(s.step) == int(js.step) and int(a.step) == int(ja.step)


def test_serving_restores_read_the_directory(tiny_config, saved):
    """restore_source / restore_adapt read the dict subtrees of an orbax
    directory without a ``like`` state."""
    tmp, js, ja = saved
    cfg = _port_cfg(tiny_config)
    params, bn = weights.restore_source(str(tmp / "src" / "step_00000004"),
                                        cfg, "cpu")
    want = jckpt._flatten(js)
    for field, tree in (("params", params), ("bn_state", bn)):
        for k, v in weights.flatten(tree, field).items():
            assert np.array_equal(v, want[k]), k
    out = weights.restore_adapt(str(tmp / "adapt" / "step_00000006"), cfg,
                                "cpu")
    want = jckpt._flatten(ja)
    for field in ("src_params", "src_bn", "dam_params", "tgt_bn"):
        for k, v in weights.flatten(out[field], field).items():
            assert np.array_equal(v, want[k]), k


def test_names_without_like_follow_the_key_types(saved):
    tmp, js, _ = saved
    flat = orbax_read.read(str(tmp / "src" / "step_00000004"))
    assert ".params['rm1']['b0']['conv1']['w']" in flat
    assert ".opt_state[0]['count']" in flat  # a NamedTuple field as a key
    assert flat[".step"].shape == ()
    assert orbax_read.names_of(".opt_state[0].mu['rm1']['w']") == \
        ("opt_state", "0", "mu", "rm1", "w")


def test_cli_resumes_a_jax_orbax_run(tiny_config, saved, tmp_path):
    """``train-source --out <JAX run dir>`` resumes at the directory's step
    4 and runs steps 4 and 5; ``loop.maybe_resume`` reads it bitwise."""
    _, js, _ = saved
    run = str(tmp_path / "run")
    jckpt.save(run, js.replace(step=np.int32(4)), step=4, block=True)
    like, _ = _port_states(tiny_config)
    state, start = loop.maybe_resume(run, like)
    assert start == 4 and int(state.step) == 4
    assert np.array_equal(weights.flatten_state(state)[".params['head']['w']"],
                          np.asarray(js.params["head"]["w"]))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(tiny_config.to_json())
    assert tcli.main(["train-source", "--config", str(cfg_path),
                      "--synthetic", "--synthetic-volumes", "2",
                      "--set", "source.steps=6", "--set", "run.log_every=1",
                      "--set", "run.ckpt_every=0", "--out", run,
                      "--device", "cpu"]) == 0
    with open(os.path.join(run, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f
                 if "loss" in json.loads(line)]
    assert steps == [4, 5]
    assert os.path.exists(os.path.join(run, "step_00000006.npz"))


def test_ckpt_serves_a_jax_orbax_run(tiny_config, saved, tmp_path):
    """``evaluate --ckpt <JAX adapt run dir>`` resolves the orbax step and
    gives the table of the same state re-saved as npz."""
    tmp, _, ja = saved
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(tiny_config.to_json())
    npz_run = tmp_path / "npz"
    npz_run.mkdir()
    np.savez(npz_run / "step_00000006.npz", **jckpt._flatten(ja))
    common = ["evaluate", "--config", str(cfg_path), "--synthetic",
              "--synthetic-volumes", "2", "--device", "cpu"]
    run = str(tmp / "adapt")
    assert tcli._resolve_ckpt(run) == os.path.join(run, "step_00000006")
    t_orbax = tcli.cmd_evaluate(tcli.build_parser().parse_args(
        [*common, "--ckpt", run]))
    t_npz = tcli.cmd_evaluate(tcli.build_parser().parse_args(
        [*common, "--ckpt", str(npz_run)]))
    assert t_orbax["mean"] == t_npz["mean"]


def test_without_tensorstore_a_directory_raises(tiny_config, saved,
                                                monkeypatch):
    tmp, _, _ = saved
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    like, _ = _port_states(tiny_config)
    step = str(tmp / "src" / "step_00000004")
    for call in (lambda: checkpoint.restore(step, like),
                 lambda: weights.restore_source(step, _port_cfg(tiny_config),
                                                "cpu"),
                 lambda: checkpoint.latest_step(str(tmp / "src")),
                 lambda: tcli._resolve_ckpt(str(tmp / "src"))):
        with pytest.raises(ValueError,
                           match=r"step_00000004 is an orbax.*tensorstore"
                                 r".*numpy\.savez"):
            call()


def test_unfinished_directory_raises(tmp_path):
    """A step directory without ``_METADATA`` (an unfinished or foreign
    save) is refused by name, not read as an empty state."""
    (tmp_path / "step_00000003").mkdir()
    with pytest.raises(ValueError, match="no _METADATA"):
        weights.read_checkpoint(str(tmp_path / "step_00000003"))
