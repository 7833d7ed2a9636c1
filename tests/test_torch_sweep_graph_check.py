"""``scripts/sweep_graph_check.py`` at a toy size on the CPU, where both of
its runs are eager: the two artifacts agree, ``--out`` is refused, and
``drivers.dispatch`` is restored after the eager run.  On the card the
same script holds the sweep's CUDA graphs against eager steps."""

import json

import pytest

from mcmda_tpu_torch.scripts import sweep_graph_check as sgc
from mcmda_tpu_torch.train import drivers

TOY = ["--direction", "ct2mri", "--device", "cpu", "--seeds", "1",
       "--source-steps", "2", "--adapt-steps", "4", "--eval-every", "2",
       "--volumes", "1", "--depth", "8", "--set", "data.slice_size=64"]


def test_toy_sweep_graph_and_eager_agree(tmp_path, capsys):
    real = drivers.dispatch
    assert sgc.main(["--out-dir", str(tmp_path), "--", *TOY])
    assert drivers.dispatch is real
    out = capsys.readouterr().out
    assert "curves and per-seed rows equal" in out
    arts = [json.loads((tmp_path / f"sweep-{m}.json").read_text())
            for m in ("graph", "eager")]
    assert arts[0]["curves"] == arts[1]["curves"]
    assert [len(c) for c in arts[0]["curves"].values()] == [2]


def test_out_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="--out"):
        sgc.main(["--out-dir", str(tmp_path), "--", *TOY, "--out", "x"])
