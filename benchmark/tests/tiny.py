"""A copy of the benchmark's files at a size the CPU holds: every cell's
configuration with small slices, batches of 2 and one train step per
call (the CPU runs no graph), and its traffic with a few 4-slice
volumes.  The widths and every
other setting stay the configuration's."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def make_root(tmp: Path, size: int = 32) -> Path:
    """A checkout-like root under ``tmp`` holding ``BENCHMARK.json`` and
    the benchmark's data files, shrunk to ``size``^2 slices.  The critic's
    last instance norm needs 2 x 2 patches, so adaptation needs 128."""
    root = tmp / f"root{size}"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for f in (root / "benchmark" / "configs").glob("*.json"):
        conf = json.loads(f.read_text())
        exp = conf["experiment"]
        exp["data"].update(slice_size=size, batch_size=2)
        exp["run"]["log_every"] = 1
        f.write_text(json.dumps(conf))
    for f in (root / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        for k in ("volumes", "src_volumes", "tgt_volumes", "pool"):
            if k in t:
                t[k] = 2
        t["depth"] = 4
        f.write_text(json.dumps(t))
    return root
