"""Multi-process data parallelism through the port's CLI and API on the
CPU (twin of ``tests/test_multihost.py``): real processes joined in a gloo
group of 2, on ``configs/smoke.json`` at 32x32, 2 slices per rank.

- ``train-source --multihost`` and ``adapt --multihost`` with the
  class-ratio selection: rank 0 writes the checkpoints, ``metrics.jsonl``
  (no line twice), the snapshots and ``selection.json``; rank 1, given a
  run directory of its own, writes nothing there; both ranks print the
  same last logged metrics.
- ``train-source --dp 2 --device cpu`` (the CLI spawns its two ranks) and
  ``api.train_source(..., dp=2)`` on each of two ranks (this file run as a
  script, ``__main__`` below) write bitwise-equal checkpoints.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--synthetic", "--synthetic-volumes", "2",
          "--config", "configs/smoke.json", "--device", "cpu",
          "--set", "data.slice_size=32", "--set", "data.batch_size=2",
          "--set", "run.log_every=2", "--set", "run.ckpt_every=2"]
SOURCE = ["train-source", *COMMON, "--set", "source.steps=4"]
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(argvs) -> list:
    """Run each argv as a process at once; their outputs, once all ended
    with exit code 0."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *a], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def _ranks(argv_of_rank) -> list:
    """The port's CLI as 2 ``--multihost`` ranks over gloo."""
    port = _free_port()
    return _run([["-m", "mcmda_tpu_torch", *argv_of_rank(r), "--multihost",
                  "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                  "2", "--process-id", str(r)] for r in range(2)])


def _last_logged(log: str, rank: int) -> str:
    done = [ln for ln in log.splitlines()
            if ln.startswith(f"done (rank {rank} of 2)")]
    assert len(done) == 1, log[-2000:]
    return done[0].split("last logged ", 1)[1]


def _metric_lines(run_dir) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def source_run(tmp_path_factory):
    """train-source across 2 processes sharing one run directory."""
    out = tmp_path_factory.mktemp("mh") / "src"
    return out, _ranks(lambda r: [*SOURCE, "--out", str(out)])


def test_cli_train_source_multihost(source_run):
    out, logs = source_run
    for log in logs:
        assert "feed path: device-resident (per-rank sharded)" in log, log
    # every rank prints the same (rank-averaged) loss
    last = [_last_logged(log, r) for r, log in enumerate(logs)]
    assert last[0] == last[1] and "loss=" in last[0]
    names = os.listdir(out)
    assert {"step_00000002.npz", "step_00000004.npz"} <= set(names), names
    assert not [n for n in names if n.endswith(".tmp")]
    # one writer: a single coherent metrics file
    lines = _metric_lines(out)
    sigs = [(ln["step"], frozenset(ln)) for ln in lines]
    assert len(sigs) == len(set(sigs)), "multi-writer duplicate lines"
    assert any("loss" in ln for ln in lines)


def test_cli_adapt_multihost_selection(source_run, tmp_path):
    """adapt across 2 processes with the class-ratio selection; rank 1 has
    a run directory of its own, which must stay unwritten."""
    src, _ = source_run
    outs = [tmp_path / "adapt0", tmp_path / "adapt1"]
    logs = _ranks(lambda r: [
        "adapt", *COMMON, "--set", "adapt.steps=4",
        "--set", "adapt.pretrain_steps=0", "--source-ckpt", str(src),
        "--out", str(outs[r])])
    last = [_last_logged(log, r) for r, log in enumerate(logs)]
    assert last[0] == last[1] and "d_loss=" in last[0]
    with open(outs[0] / "selection.json") as f:
        rec = json.load(f)
    assert rec["signal"] == "class_ratio" and 0 < rec["best_step"] <= 4
    assert (outs[0] / f"step_{rec['best_step']:08d}.npz").exists()
    assert os.listdir(outs[0] / "snapshots")
    lines = _metric_lines(outs[0])
    sigs = [(ln["step"], frozenset(ln)) for ln in lines]
    assert len(sigs) == len(set(sigs)), "multi-writer duplicate lines"
    assert any("class_ratio_dist" in ln for ln in lines)
    assert not outs[1].exists()


def test_cli_dp_and_api_dp_write_the_same_checkpoint(tmp_path):
    """``--dp 2 --device cpu`` through the CLI against ``dp=2`` through
    the API on two ranks: every tensor of the final checkpoint bitwise
    equal."""
    cli_out, api_out = tmp_path / "cli", tmp_path / "api"
    port = _free_port()
    log = _run([["-m", "mcmda_tpu_torch", *SOURCE, "--set",
                 "source.steps=3", "--out", str(cli_out), "--dp", "2"]]
               + [[os.path.abspath(__file__), str(api_out), str(r),
                   str(port)] for r in range(2)])[0]
    assert log.count("(per-rank sharded)") == 2, log[-2000:]
    a = np.load(cli_out / "step_00000003.npz")
    b = np.load(api_out / "step_00000003.npz")
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _api_rank(out: str, rank: int, port: int) -> None:
    """One rank of ``api.train_source(..., dp=2)`` on the data and config
    the CLI builds from the same arguments."""
    from mcmda_tpu_torch import api, cli, config
    from mcmda_tpu_torch.parallel import multihost
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
    args = cli.build_parser().parse_args(
        [*SOURCE, "--set", "source.steps=3", "--out", out])
    cfg = config.load_config(args.config, args.set)
    vols, labs = cli._get_data(args, cfg)[0]
    api.train_source(cfg, vols, labs, out_dir=out, dp=2, device="cpu")
    dist.destroy_process_group()


if __name__ == "__main__":
    _api_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
