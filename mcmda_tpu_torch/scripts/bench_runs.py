"""Repeated runs of the port's bench, kept as one artifact::

    python -m mcmda_tpu_torch.scripts.bench_runs --out <json>
    python -m mcmda_tpu_torch.scripts.bench_runs --table <json>

The first form runs ``python -m mcmda_tpu_torch.bench`` ``RUNS`` times,
one process after another on one card (the spread of one call's runs),
and writes ``{"command", "card", "runs": [each run's JSON line]}``; any
run that fails ends it non-zero.
Both forms print a markdown table of every figure of the runs: the median
and the smallest and largest value.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

COMMAND = [sys.executable, "-m", "mcmda_tpu_torch.bench"]
RUNS = 3


def run_bench() -> dict:
    """One run of the bench in a process of its own: its last line."""
    out = subprocess.run(COMMAND, capture_output=True, text=True)
    sys.stderr.write(out.stderr[-4000:])
    if out.returncode != 0:
        raise RuntimeError(f"the bench exited {out.returncode}: "
                           f"{out.stdout.strip()[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def figures(line: dict) -> dict:
    """The numbers of one run: ``value`` and ``vs_baseline``, then
    ``extra``'s numbers, nested keys joined by dots (flags and texts
    left out)."""
    out = {"value": line["value"], "vs_baseline": line["vs_baseline"]}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (int, float)) and not isinstance(node, bool):
            out[prefix[:-1]] = node

    walk("", line["extra"])
    return out


def table(artifact: dict) -> str:
    """Markdown: one row per figure, the median and the range over the
    runs, with the card."""
    runs = [figures(r) for r in artifact["runs"]]
    rows = [f"Card: {artifact['card']}; {len(runs)} runs of "
            f"`{artifact['command']}`", "",
            "| figure | median | min | max |", "|---|---|---|---|"]
    for key in runs[0]:
        vals = [r[key] for r in runs if key in r]
        rows.append(f"| `{key}` | {float(np.median(vals))!r} | "
                    f"{min(vals)!r} | {max(vals)!r} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m mcmda_tpu_torch.scripts."
                                "bench_runs", description=__doc__)
    p.add_argument("--out", help="where to write the artifact")
    p.add_argument("--table", help="print the table of an artifact")
    args = p.parse_args(argv)
    if args.table:
        with open(args.table) as f:
            print(table(json.load(f)))
        return 0
    if not args.out:
        p.error("--out or --table")
    runs = [run_bench() for _ in range(RUNS)]
    cards = {r["extra"]["card"] for r in runs}
    if len(cards) != 1:
        raise RuntimeError(f"the runs saw cards {cards}")
    artifact = {"command": "python -m mcmda_tpu_torch.bench",
                "card": cards.pop(), "runs": runs}
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(table(artifact))
    return 0


if __name__ == "__main__":
    sys.exit(main())
