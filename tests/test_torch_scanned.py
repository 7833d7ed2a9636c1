"""The multi-step dispatch of the port against the JAX package's, on the
CPU at the tests' tiny config.

- ``drivers.pick_inner`` equals the JAX package's over a grid of counts and
  caps (exact: integer arithmetic).
- ``loop.run(inner_steps=k)`` logs, probes, checkpoints, calls back and
  saves on preemption at exactly the steps the JAX ``loop.run`` does, with
  the same fake step (exact: step numbers and the logged values).
- ``loop.scanned_step`` through ``drivers.device_resident_dp`` equals k
  single steps seeded ``prng.fold_in(seed, i)``, bitwise (``torch.equal``:
  the same operations on the same numbers), for T1 and for adaptation at
  rm3 and rm2, with the critic throttle and with the weight average; at
  k = 1 it is the step with the call's seed.
- The port's CLI writes ``metrics.jsonl`` step keys and checkpoint names
  equal to the JAX CLI's on the device-resident path (exact).
- ``run.donate`` true and false write the same checkpoints (bitwise).
- Two gloo ranks: k steps per call equal k single data-parallel steps
  (bitwise; the ranks are subprocesses running this file as a script).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mcmda_tpu_torch import cli as tcli, config as tcfg, weights
from mcmda_tpu_torch.data import pipeline, synthetic, volumes
from mcmda_tpu_torch.parallel import dp as dp_mod
from mcmda_tpu_torch.train import adapt, drivers, loop, source
from mcmda_tpu_torch.utils import prng, tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def _port_cfg(cfg, **sections):
    out = tcfg.ExperimentConfig.from_json(cfg.to_json())
    for name, fields in sections.items():
        out = dataclasses.replace(out, **{name: dataclasses.replace(
            getattr(out, name), **fields)})
    return out


# ------------------------------------------------------------- pick_inner
@pytest.mark.parametrize("cap", [1, 7, 50, 64])
def test_pick_inner_matches_jax(cap):
    from mcmda_tpu.train import drivers as jdrivers
    grid = [(), (0,), (0, 0), (20000, 50, 1000), (0, 10000, 50, 1000, 100),
            (300, 50), (97,), (7, 11), (12, 18, 0, 30), (250, 100),
            (64, 48, 0), (1,), (5000, 0, 1000, 250), (13, 26, 39)]
    for counts in grid:
        assert drivers.pick_inner(*counts, cap=cap) == \
            jdrivers.pick_inner(*counts, cap=cap), (counts, cap)
    assert drivers.pick_inner(20000, 50, 1000) == 50
    assert drivers.pick_inner(0, 10000, 50, 1000, 100) == 50


# ------------------------------------------------------- loop.run schedule
class _Guard:
    """Stands for the loop's SIGTERM guard: ``fired`` is set by the fake
    step at a chosen call."""

    def __init__(self):
        self.fired = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Log:
    def __init__(self):
        self.rows = []

    def log(self, step, scalars):
        self.rows.append((int(step), {k: float(v)
                                      for k, v in scalars.items()}))


def _drive(mod, k, num_steps, log_every, ckpt_every, probe_every, start,
           fire_at, monkeypatch, tensor):
    """Every event ``mod.run`` fires with a fake step advancing k steps
    per call: [(event, step, value)]."""
    events = []
    guard = _Guard()
    calls = [0]

    class _Ckpt:
        @staticmethod
        def save(path, state, step, **kw):
            events.append(("save", int(step), float(state)))

        @staticmethod
        def prune(path, keep, protect=(), newest=None):
            events.append(("prune", int(newest), None))

    monkeypatch.setattr(mod, "checkpoint", _Ckpt)
    monkeypatch.setattr(mod, "_PreemptionGuard", lambda: guard)

    def step(state, batch, seed):
        calls[0] += 1
        if fire_at is not None and calls[0] == fire_at:
            guard.fired = True
        new = state + k
        return new, {"v": tensor(float(new))}

    log = _Log()
    state, last = mod.run(
        step, float(start), iter(lambda: None, 1), num_steps, seed=3,
        log_every=log_every, ckpt_every=ckpt_every, ckpt_dir="unused",
        logger=log, start_step=start,
        callback=lambda s, st, m: events.append(("callback", s, m["v"])),
        keep_checkpoints=2, inner_steps=k,
        protect_steps=lambda: (),
        probe_every=probe_every,
        probe=lambda s, st, m: events.append(("probe", s, float(m["v"]))))
    events += [("log", s, m["v"]) for s, m in log.rows]
    return events, float(state), {kk: float(v) for kk, v in last.items()}


SCHEDULES = [
    # k, num_steps, log_every, ckpt_every, probe_every, start, preempt at
    (1, 12, 5, 4, 3, 0, None),
    (1, 12, 5, 4, 3, 5, 3),
    (2, 20, 4, 6, 2, 0, None),
    (2, 20, 4, 6, 8, 6, 4),
    (5, 60, 10, 20, 15, 0, None),
    (5, 60, 7, 25, 10, 10, None),
    (5, 40, 10, 10, 5, 15, 2),
    (50, 300, 50, 100, 100, 0, None),
    (50, 1000, 100, 250, 150, 200, None),
    (50, 500, 50, 200, 100, 100, 5),
]


@pytest.mark.parametrize("k,num_steps,log_every,ckpt_every,probe_every,"
                         "start,fire_at", SCHEDULES)
def test_run_schedule_matches_jax(monkeypatch, k, num_steps, log_every,
                                  ckpt_every, probe_every, start, fire_at):
    import jax.numpy as jnp
    from mcmda_tpu.train import loop as jloop
    got = _drive(loop, k, num_steps, log_every, ckpt_every, probe_every,
                 start, fire_at, monkeypatch, torch.tensor)
    want = _drive(jloop, k, num_steps, log_every, ckpt_every, probe_every,
                  start, fire_at, monkeypatch, jnp.float32)
    assert got == want
    if (k, num_steps, log_every, start) == (50, 300, 50, 0):
        assert [s for e, s, _ in got[0] if e == "log"] == \
            [49, 99, 149, 199, 249, 299]


# ----------------------------------------------- scanned_step vs k steps
def _assert_states_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


@pytest.fixture(scope="module")
def resident():
    mri_v, mri_l = synthetic.make_dataset(0, "mri", 1, 8, 32)
    ct_v, _ = synthetic.make_dataset(0, "ct", 1, 8, 32)
    src = volumes.volumes_to_slices(mri_v, mri_l, context=3, drop_empty=True)
    tgt = volumes.volumes_to_slices(ct_v, context=3)
    return {"t1": pipeline.to_device_arrays(src, 5, "cpu"),
            "ad": {"src": pipeline.to_device_arrays(src, device="cpu"),
                   "tgt": pipeline.to_device_arrays(tgt, device="cpu")}}


ADAPT_CASES = {
    "rm3": dict(plug_depth="rm3"),
    "rm2-throttle": dict(plug_depth="rm2", d_acc_cap=0.5),
    "rm2-ema": dict(plug_depth="rm2", d_acc_cap=0.9, dam_ema=0.5),
}


def _setup(tiny_config, case):
    if case == "t1":
        cfg = _port_cfg(tiny_config)
        return cfg, source.make_train_step, source.init_state(0, cfg, "cpu")
    cfg = _port_cfg(tiny_config, adapt=ADAPT_CASES[case])
    src = source.init_state(0, cfg, "cpu")
    return cfg, adapt.make_adapt_step, adapt.init_state(
        2, cfg, src.params, src.bn_state)


@pytest.mark.parametrize("case", ["t1", *ADAPT_CASES])
def test_scanned_step_equals_single_steps(tiny_config, resident, case):
    """k = 3 steps per call through ``device_resident_dp`` against three
    calls of the step with the seeds ``fold_in(seed, i)``: states and the
    last step's metrics bitwise equal."""
    k, seed = 3, 12345
    cfg, make_step, state = _setup(tiny_config, case)
    data = resident["t1" if case == "t1" else "ad"]
    scanned, got_data = drivers.device_resident_dp(
        cfg, make_step, 0, k, lambda _group: data, device="cpu")
    assert got_data is data
    got, got_m = scanned(state, data, seed)
    single = make_step(cfg, sample_from_device=True)
    want = state
    for i in range(k):
        want, want_m = single(want, data, prng.fold_in(seed, i))
    _assert_states_equal(got, want)
    assert set(got_m) == set(want_m)
    for name in got_m:
        assert torch.equal(got_m[name], want_m[name]), name
    assert int(got.step) == k
    if case == "rm2-throttle":
        # the throttle's held steps leave the critic's Adam count behind
        held = k - int(got.opt_d_state[0].count)
        print(f"throttle held {held} of {k}")


def test_one_step_scan_is_the_step(tiny_config, resident):
    """At k = 1 a call is the step with the call's own seed: what a run
    drew before the multi-step dispatch existed (exact)."""
    cfg, make_step, state = _setup(tiny_config, "t1")
    data = resident["t1"]
    got, got_m = loop.scanned_step(make_step(cfg, sample_from_device=True),
                                   1)(state, data, 99)
    want, want_m = make_step(cfg, sample_from_device=True)(state, data, 99)
    _assert_states_equal(got, want)
    assert all(torch.equal(got_m[k], want_m[k]) for k in want_m)


@pytest.mark.parametrize("case", ["t1", "rm2-ema"])
def test_tree_walks_training_states(tiny_config, case):
    """``tree.leaves`` / ``tree.unflatten``, which the graph's static
    buffers are built with, round-trip a whole training state: the same
    types, the new tensors in the old ones' places, constants kept
    (exact)."""
    _, _, state = _setup(tiny_config, case)
    old = tree.leaves(state)
    assert old and all(isinstance(t, torch.Tensor) for t in old)
    new = [t.clone() for t in old]
    back = tree.unflatten(state, new)
    assert type(back) is type(state)
    assert [id(t) for t in tree.leaves(back)] == [id(t) for t in new]
    assert weights.flatten_state(back).keys() == \
        weights.flatten_state(state).keys()
    assert tree.unflatten({"a": None, "b": (1, old[0])}, [new[0]]) == \
        {"a": None, "b": (1, new[0])}


def test_tree_order_is_jax_order_whatever_the_dicts_were_built_in(
        tiny_config):
    """A train forward returns its BN state with the keys in forward order
    (a projected block's ``bn_p`` before its ``bn2``); ``segmenter.init``,
    and a source state restored from a checkpoint, hold them in init order.
    ``tree.leaves`` gives both in ``jax.tree_util``'s order (keys sorted),
    so a graph's static buffers, which are filled by position, take each
    leaf at its own key.  In insertion order a seed sweep on a loaded
    source state copied ``bn2``'s running statistics into ``bn_p``'s
    buffers and back: same shapes, so nothing raised (exact: identity of
    the leaves)."""
    import jax

    from mcmda_tpu_torch.models import segmenter

    cfg = _port_cfg(tiny_config)
    params, init_bn = segmenter.init(cfg.segmenter, device="cpu")
    x = torch.zeros(2, cfg.data.slice_size, cfg.data.slice_size,
                    cfg.data.context_slices)
    fwd_bn = segmenter.apply(params, init_bn, x, cfg.segmenter,
                             train=True)[3]

    def by_path(node, pre=""):
        if isinstance(node, dict):
            return {p: t for k, v in node.items()
                    for p, t in by_path(v, f"{pre}/{k}").items()}
        return {pre: node}

    # the fault's premise: the two BN states list their keys in two orders
    assert list(by_path(init_bn)) != list(by_path(fwd_bn))
    assert sorted(by_path(init_bn)) == sorted(by_path(fwd_bn))
    for bn in (init_bn, fwd_bn):
        assert [id(t) for t in tree.leaves(bn)] == \
            [id(t) for t in jax.tree_util.tree_leaves(bn)]
    # a state built in one order, filled from one built in the other
    filled = by_path(tree.unflatten(init_bn, tree.leaves(fwd_bn)))
    assert all(filled[p] is t for p, t in by_path(fwd_bn).items())


def test_dispatch_is_eager_on_the_cpu():
    assert drivers.dispatch("cpu") == "eager"
    assert drivers.dispatch("cuda") == "graph"
    assert drivers.feed_line(True, 50, 0, "cpu") == \
        "feed path: device-resident; 50 eager steps per call"
    assert drivers.feed_line(True, 50, 0, "cuda") == \
        "feed path: device-resident; 50 steps per call on a CUDA graph"
    assert drivers.feed_line(False, 1, 0, "cpu") == \
        "feed path: host-sampler; one eager step per call"


def test_graph_step_refuses_cpu_tensors(tiny_config, resident):
    """The graph path never runs CPU tensors eagerly instead."""
    cfg, make_step, state = _setup(tiny_config, "t1")
    step = loop.scanned_step(make_step(cfg, sample_from_device=True), 2,
                             graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        step(state, resident["t1"], 0)


# ------------------------------------------------- the CLIs, step by step
def _steps(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line)["step"] for line in f]


def _ckpt_names(run):
    return sorted(n[:-4] if n.endswith(".npz") else n
                  for n in os.listdir(run) if n.startswith("step_"))


_CLI_SETS = ("source.steps=8", "run.log_every=4", "run.ckpt_every=2",
             "adapt.pretrain_steps=2", "adapt.steps=8",
             "adapt.select_every=2", "run.donate=false")


@pytest.fixture(scope="module")
def cli_runs(tiny_config, tmp_path_factory):
    """train-source then adapt through both CLIs on the device-resident
    feed: inner = pick_inner(8, 4, 2) = 2 for T1, pick_inner(2, 8, 4, 2,
    2) = 2 for adaptation."""
    from mcmda_tpu import cli as jcli
    tmp = tmp_path_factory.mktemp("cli")
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(tiny_config.to_json())
    common = ["--config", str(cfg_path), "--synthetic",
              "--synthetic-volumes", "2"]
    for kv in _CLI_SETS:
        common += ["--set", kv]
    runs = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        src, ad = str(tmp / f"{name}_src"), str(tmp / f"{name}_ad")
        main(["train-source", *common, *extra, "--out", src])
        main(["adapt", *common, *extra, "--source-ckpt", src, "--out", ad])
        runs[name] = {"src": src, "ad": ad}
    return runs


@pytest.mark.parametrize("phase", ["src", "ad"])
def test_cli_steps_match_jax_cli(cli_runs, phase):
    port, jax_run = cli_runs["port"][phase], cli_runs["jax"][phase]
    assert _steps(port) == _steps(jax_run)
    assert _ckpt_names(port) == _ckpt_names(jax_run)
    if phase == "src":
        # the JAX rule at k = 2, log_every 4: steps 1 and 5 and the last,
        # 7, each written one tick later, and val_dice at the checkpoints
        # 2, 4, 6 as they happen
        assert _steps(port) == [2, 4, 1, 6, 5, 7]


def test_cli_prints_the_dispatch(tiny_config, tmp_path, capsys):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(tiny_config.to_json())
    assert tcli.main(["train-source", "--config", str(cfg_path),
                      "--synthetic", "--synthetic-volumes", "2",
                      "--set", "source.steps=4", "--set", "run.log_every=2",
                      "--set", "run.ckpt_every=0", "--device", "cpu",
                      "--out", str(tmp_path / "src")]) == 0
    assert "feed path: device-resident; 2 eager steps per call" in \
        capsys.readouterr().out


# ---------------------------------------------------------- run.donate
def test_donate_true_and_false_write_the_same_checkpoints(tiny_config,
                                                         tmp_path):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(tiny_config.to_json())
    runs = []
    for donate in ("true", "false"):
        out = str(tmp_path / f"src_{donate}")
        assert tcli.main(["train-source", "--config", str(cfg_path),
                          "--synthetic", "--synthetic-volumes", "2",
                          "--set", "source.steps=6", "--set",
                          "run.log_every=2", "--set", "run.ckpt_every=2",
                          "--set", f"run.donate={donate}", "--device", "cpu",
                          "--out", out]) == 0
        runs.append(out)
    names = [sorted(n for n in os.listdir(r) if n.endswith(".npz"))
             for r in runs]
    assert names[0] == names[1] and "step_00000006.npz" in names[0]
    for name in names[0]:
        a = weights.read_checkpoint(os.path.join(runs[0], name))
        b = weights.read_checkpoint(os.path.join(runs[1], name))
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ------------------------------------------- data parallel, two gloo ranks
def _rank_main(out_dir, rank, port):
    """This rank's 3 steps per call through ``device_resident_dp`` against
    three single data-parallel steps of its group step, T1 and adapt."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    with open(os.path.join(out_dir, "cfg.json")) as f:
        cfg = tcfg.ExperimentConfig.from_json(f.read())
    k, seed = 3, 777
    mri_v, mri_l = synthetic.make_dataset(0, "mri", 2, 8, 32)
    ct_v, _ = synthetic.make_dataset(0, "ct", 2, 8, 32)
    src = drivers.shard(volumes.volumes_to_slices(
        mri_v, mri_l, context=3, drop_empty=True), WORLD, "cpu")
    tgt = drivers.shard(volumes.volumes_to_slices(ct_v, context=3),
                        WORLD, "cpu")
    datas = {"t1": pipeline.to_device_arrays(src, 5, "cpu"),
             "ad": {"src": pipeline.to_device_arrays(src, device="cpu"),
                    "tgt": pipeline.to_device_arrays(tgt, device="cpu")}}
    s0 = source.init_state(0, cfg, "cpu")
    states = {"t1": s0, "ad": adapt.init_state(2, cfg, s0.params,
                                               s0.bn_state)}
    makers = {"t1": source.make_train_step, "ad": adapt.make_adapt_step}
    res = {}
    group = drivers.dp_group(WORLD, "cpu")
    for name in ("t1", "ad"):
        data = datas[name]
        step, _ = drivers.device_resident_dp(
            cfg, makers[name], WORLD, k, lambda _g: data, device="cpu")
        got, got_m = step(states[name], data, seed)
        single = makers[name](cfg, group=group, sample_from_device=True)
        want = states[name]
        rank_seed = prng.fold_in(seed, dist.get_rank(group))
        for i in range(k):
            want, want_m = single(want, data, prng.fold_in(rank_seed, i))
        want_m = dp_mod.mean_metrics(want_m, group)
        for key, v in weights.flatten_state(got).items():
            res[f"{name}/got/{key}"] = np.asarray(v)
        for key, v in weights.flatten_state(want).items():
            res[f"{name}/want/{key}"] = np.asarray(v)
        for key in got_m:
            res[f"{name}/gotm/{key}"] = got_m[key].numpy()
            res[f"{name}/wantm/{key}"] = want_m[key].numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dp_ranks(tiny_config, tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_scan")
    (out / "cfg.json").write_text(_port_cfg(tiny_config).to_json())
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out), str(r),
         str(port)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("name", ["t1", "ad"])
def test_dp_scanned_equals_single_dp_steps(dp_ranks, name):
    for res in dp_ranks:
        got = {k.split("/", 2)[2]: v for k, v in res.items()
               if k.startswith(f"{name}/got/")}
        want = {k.split("/", 2)[2]: v for k, v in res.items()
                if k.startswith(f"{name}/want/")}
        assert got and set(got) == set(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        for key in [k for k in res if k.startswith(f"{name}/gotm/")]:
            np.testing.assert_array_equal(
                res[key], res[key.replace("/gotm/", "/wantm/")], err_msg=key)
    # the ranks hold one state
    for key in [k for k in dp_ranks[0] if k.startswith(f"{name}/got/")]:
        np.testing.assert_array_equal(dp_ranks[0][key], dp_ranks[1][key],
                                      err_msg=key)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
