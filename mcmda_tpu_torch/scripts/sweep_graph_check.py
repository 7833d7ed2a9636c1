"""The seed sweep on the CUDA graphs against its eager twin.

Runs ``seed_sweep.main`` twice with the same arguments: once as the port
runs it (on a GPU every train step and probe is a CUDA graph), once with
``drivers.dispatch`` answering "eager".  The graphs replay the eager
path's kernels in the same order, so every curve value and every per-seed
row of the two artifacts must be equal; exit 1 if they are not.  On the
CPU both runs are eager.

Usage (from the root of a checkout; the arguments after ``--`` go to
``seed_sweep``, which must not get ``--out``)::

    python -m mcmda_tpu_torch.scripts.sweep_graph_check --out-dir DIR -- \\
        --direction ct2mri --set segmenter.train_fused=pallas \\
        --source-ckpt ct2mri_source.npz --adapt-steps 1000 --seeds 1
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from mcmda_tpu_torch.scripts import seed_sweep
from mcmda_tpu_torch.train import drivers


@contextlib.contextmanager
def eager_dispatch():
    """``drivers.dispatch`` answers "eager" inside the block."""
    real = drivers.dispatch
    drivers.dispatch = lambda *a, **k: "eager"
    try:
        yield
    finally:
        drivers.dispatch = real


def main(argv=None) -> bool:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", required=True)
    p.add_argument("sweep_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    sweep_args = [a for a in args.sweep_args if a != "--"]
    if "--out" in sweep_args:
        raise SystemExit("sweep_graph_check: --out is its own (--out-dir)")
    arts = {}
    for mode in ("graph", "eager"):
        ctx = eager_dispatch() if mode == "eager" else \
            contextlib.nullcontext()
        t0 = time.time()
        with ctx:
            out = seed_sweep.main([*sweep_args, "--out", os.path.join(
                args.out_dir, f"sweep-{mode}.json")])
        arts[mode] = json.loads(json.dumps(out))  # as the file holds it
        print(f"[check] {mode}: {time.time() - t0:.1f} s, dispatch "
              f"{arts[mode]['settings']['dispatch']}", flush=True)
    g, e = arts["graph"], arts["eager"]
    differ = sorted({k for s in g["curves"] for a, b in
                     zip(g["curves"][s], e["curves"][s])
                     for k in a if a[k] != b.get(k)})
    same = g["curves"] == e["curves"] and g["per_seed"] == e["per_seed"]
    for s, curve in g["curves"].items():
        print(f"[check] seed {s}: {len(curve)} ticks; d_acc "
              f"{[r['d_acc'] for r in curve]}; live Dice "
              f"{[r['dice'] for r in curve]}", flush=True)
    print(f"[check] curves and per-seed rows "
          f"{'equal' if same else 'DIFFER'}; curve keys that differ: "
          f"{differ}", flush=True)
    return same


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
