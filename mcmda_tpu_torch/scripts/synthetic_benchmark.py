"""Full synthetic-phantom benchmark through the port's CLI: the twin of
``scripts/synthetic_benchmark.sh``.

For each direction it runs ``train-source``, ``evaluate --source-only``,
``adapt`` and ``evaluate`` (resolved through ``selection.json``) with the
shipped config, then prints the table::

    python -m mcmda_tpu_torch.scripts.synthetic_benchmark \\
        --set segmenter.train_fused=pallas --set run.use_pallas=true

Each direction writes ``torch_synthetic_{dir}_{no_adapt,adapted}.json``
(the ``evaluate --json-out`` table) under ``--results-dir``; the JAX
package's ``results/synthetic_*.json`` are never written.  ``--set``
overrides go to every command (``run.use_pallas`` acts on ``evaluate``
only).  A command that finds checkpoints under ``--runs`` resumes from the
newest, as the CLI does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from mcmda_tpu_torch import cli
from mcmda_tpu_torch.utils import device as device_mod

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DIRECTIONS = ("mri2ct", "ct2mri")
KINDS = ("no_adapt", "adapted")


def result_path(results_dir: str, direction: str, kind: str) -> str:
    return os.path.join(results_dir, f"torch_synthetic_{direction}_{kind}.json")


def run_direction(direction: str, args) -> None:
    """The four commands of one direction, each through ``cli.main``."""
    out = os.path.join(args.runs, direction)
    common = ["--config", os.path.join(args.config_dir, f"{direction}.json"),
              "--direction", direction, "--synthetic", "--device",
              args.device, *(a for kv in args.set for a in ("--set", kv))]
    commands = [
        ["train-source", *common, "--out", os.path.join(out, "src")],
        ["evaluate", *common, "--ckpt", os.path.join(out, "src"),
         "--source-only", "--json-out",
         result_path(args.results_dir, direction, "no_adapt")],
        ["adapt", *common, "--source-ckpt", os.path.join(out, "src"),
         "--out", os.path.join(out, "adapt")],
        ["evaluate", *common, "--ckpt", os.path.join(out, "adapt"),
         "--json-out", result_path(args.results_dir, direction, "adapted")],
    ]
    for argv in commands:
        name = f"{direction}: {argv[0]}" + (
            " --source-only" if "--source-only" in argv else "")
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        rc = cli.main(argv)
        if rc != 0:
            raise SystemExit(f"{name} returned {rc}")
        print(f"== {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def table(results_dir: str, directions) -> list[str]:
    """The reference script's table, with the mean ASSD beside the Dice."""
    lines = []
    for d in directions:
        for kind in KINDS:
            with open(result_path(results_dir, d, kind)) as f:
                mean = json.load(f)["mean"]
            lines.append(f"{d} {kind:9s} mean dice {mean['dice']:.3f} "
                         f"assd {mean['assd']:.3f}")
    return lines


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", default="runs/torch_synthetic",
                   help="run directories (the reference script's RUNS)")
    p.add_argument("--results-dir",
                   default=os.path.join("results", "torch_h100"))
    p.add_argument("--direction", choices=DIRECTIONS + ("both",),
                   default="both")
    p.add_argument("--set", action="append", default=[],
                   metavar="K.EY=VAL",
                   help="config override passed to every command")
    p.add_argument("--config-dir", default=os.path.join(ROOT, "configs"))
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    directions = DIRECTIONS if args.direction == "both" else (args.direction,)
    os.makedirs(args.results_dir, exist_ok=True)
    if args.device.startswith("cuda"):
        print(f"card: {device_mod.card()}", flush=True)
    for d in directions:
        run_direction(d, args)
    print("== synthetic benchmark tables ==")
    for line in table(args.results_dir, directions):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
