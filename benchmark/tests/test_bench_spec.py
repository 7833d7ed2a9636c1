"""A configuration, a traffic mix, a per-layer metric and a cell added as
files and entries alone are found by name and run."""

import json

from benchmark import run
from benchmark.cells import Reading, experiment
from benchmark.spec import Spec
from benchmark.tests.tiny import make_root
from benchmark.trace import Trace

METRIC = '''"""Slices through the serving forward per volume traced."""

UNIT = "slices"
LAYER = "volume loop"
MOVES = "serve_slices_per_s"


def read(r):
    if r.kind != "serve":
        return None
    forwards = -(-r.traffic["depth"] // r.batch)
    return forwards * r.forward_batch
'''


def test_a_cell_added_as_files_alone(tmp_path):
    root = make_root(tmp_path)
    b = root / "benchmark"
    conf = json.loads((b / "configs" / "mri2ct.json").read_text())
    conf["experiment"]["run"]["eval_tta"] = "flip"
    (b / "configs" / "mri2ct_tta.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "serve.json").read_text())
    mix["pool"] = 3
    (b / "traffic" / "serve3.json").write_text(json.dumps(mix))
    (b / "limits" / "mri2ct_tta.serve3.json").write_text(
        (b / "limits" / "mri2ct.serve.json").read_text())
    (b / "metrics" / "slices_per_volume.py").write_text(METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="mri2ct_tta",
                                 file="benchmark/configs/mri2ct_tta.json"))
    bench["workloads"].append({"name": "mri2ct_tta.serve3",
                               "config": "mri2ct_tta", "traffic": "serve3",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "slices_per_volume", "unit": "slices", "better": "lower",
        "source": "program_counter", "layer": "volume loop",
        "moves": "serve_slices_per_s", "workloads": ["mri2ct_tta.serve3"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "mri2ct.serve" in m["workloads"]:
            m["workloads"].append("mri2ct_tta.serve3")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(root)
    cell = "mri2ct_tta.serve3"
    assert spec.traffic(spec.cell(cell)["traffic"])["pool"] == 3
    assert [m["name"] for m in spec.end_to_end(cell)] == [
        "serve_slices_per_s", "volume_ms_p95", "setup_s"]
    assert "slices_per_volume" in [m["name"] for m in spec.per_layer(cell)]
    out = run.run_cell(spec, cell, 2**32 + 5, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"serve_slices_per_s", "volume_ms_p95",
                                   "setup_s"}
    # the new metric reads the cell's own shapes: a 4-slice volume takes
    # two forwards of a batch of 2, doubled under flip TTA
    c = spec.config("mri2ct_tta")
    r = Reading("serve", Trace([("k", 0.0, 1.0)], [], (0.0, 1.0)), 1, c,
                experiment(c, 0), spec.traffic("serve3"))
    assert spec.reader("slices_per_volume").read(r) == 8
