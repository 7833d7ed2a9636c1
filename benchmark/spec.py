"""``BENCHMARK.json`` and the files it names, found by name.

Under the benchmark's folder, beside the code:

- ``<config file>`` (the configuration's ``file``): the package's
  experiment config as it is run (``experiment``), the domains its
  source and target data come from, its source and every change from it;
- ``traffic/<mix>.json``: a traffic mix's parameters (``kind`` names the
  general code in ``cells.py`` that runs it, the rest are its sizes);
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: a per-layer metric's reader (``UNIT``,
  ``LAYER``, ``MOVES``, ``read(reading)``, which returns None where the
  cell holds nothing to read).  A ``cells.Reading`` holds the traced
  slice and the cell that ran it (its configuration, the package's
  config of it, its traffic), from which a reader works out its own
  shapes, call sites and FLOPs.

A configuration, a mix, a metric or a cell is added by adding its files
and its entry; no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

DIR = "benchmark"


class Spec:
    def __init__(self, root="."):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, *parts) -> dict:
        return json.loads(self.root.joinpath(*parts).read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return self._json(c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json(DIR, "traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self._json(DIR, "limits", f"{cell}.json")

    def _applies(self, metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.bench["per_layer"] if self._applies(m, cell)]

    def reader(self, metric: str):
        path = self.root / DIR / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"{DIR}_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
