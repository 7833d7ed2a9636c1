"""Run one cell of the benchmark once::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, on a machine with
as many CUDA devices as the cell asks for (else it exits 2 and prints no
result).

A run: set-up (inputs and weights from the seed, the program's step or
serving graph built and warmed, the check's first calls), ``--seconds``
of measured work, with ``--trace 1`` a traced slice after it, then the
check against the plain reference once the program's state is freed.
The last line of standard output is the result, one JSON object; the
numbers the check compared, each with its limit, close standard error
and the result's ``checks``.  It exits 3 and prints no result if JAX or
the JAX package was loaded into the process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mcmda_tpu")


def jax_modules() -> list:
    """Loaded modules whose top-level name, whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "not read"


def run_cell(spec, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """The result of one run of cell ``name`` (see the module docstring)."""
    import torch

    from benchmark import cells, judge

    cell = spec.cell(name)
    limits = spec.limits(name)
    c = cells.make(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                   seed, device)
    on_gpu = torch.device(device).type == "cuda"
    t_imports = time.perf_counter()
    c.setup()
    t_setup = time.perf_counter()
    e2e = c.window(seconds)
    e2e["setup_s"] = c.window_start - T0
    # where set-up went: interpreter and imports, the cell's set-up (inputs,
    # state, the program's step and the check's first steps), and the rest
    # up to the window (a serving call's first volume, which captures)
    parts = {"imports_s": t_imports - T0, "cell_setup_s": t_setup - t_imports,
             "first_call_s": c.window_start - t_setup}
    reading = c.traced() if trace else None
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    c.release()
    readings, attempted, failed = c.check()
    correct, checks = judge.verdict(readings, limits)
    correct = correct and failed == 0 and attempted > 0

    metrics = {}
    if not trace:
        for m in spec.end_to_end(name):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in spec.per_layer(name):
            value = spec.reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = reading.trace.busy_s()
        dev["window_s"] = reading.trace.window_s
        out["breakdown"] = {"device_ops": reading.trace.device_ops(),
                            "idle_gaps": reading.trace.idle_gaps()}
    out["setup_parts"] = parts
    out["readings"] = {k: v for k, v in readings.items() if k not in limits}
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.spec import Spec
    spec = Spec(".")
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card()}", file=sys.stderr, flush=True)
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = jax_modules()
    if bad:
        print(f"the process loaded {bad}: the port must run without JAX",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
