"""The readings that the check's limits are set from, on the card, at a
cell's own size::

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        [--seconds 3]

For each seed, in one process: the cell's set-up and check calls (and,
for a serving cell, ``--seconds`` of its window), then the numbers the
check compares for the program, and for the controls put in the
program's place: the reference in the next precision below the
configuration's (TF32 products for the float32 train steps, per-tensor
fp8 for bf16 serving) and, for a train cell, the reference with each
fault of ``TrainCell.FAULTS`` planted.  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from benchmark import cells
    from benchmark.reference import pnp_adanet as ref
    from benchmark.spec import Spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = Spec(".")
    cell = spec.cell(args.workload)
    conf, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        c = cells.make(conf, traffic, seed, "cuda")
        c.setup()
        line = {"workload": args.workload, "seed": seed,
                "setup_s": time.perf_counter() - t0}
        if c.kind == "serve":
            line["e2e"] = c.window(args.seconds)
        c.release()
        t1 = time.perf_counter()
        if c.kind == "train":
            side = c.reference()
            line["ref_s"] = time.perf_counter() - t1
            line["program"] = c.readings(side)
            line["losses"] = {"program": c.prog["losses"],
                              "reference": side["losses"]}
            line["control_tf32"] = c.readings(
                side, c.reference(ref.tf32_round))
            for fault in c.FAULTS:
                line[f"fault_{fault}"] = c.readings(
                    side, c.reference(fault=fault))
        else:
            probs = c.reference_probs()
            line["ref_s"] = time.perf_counter() - t1
            line["program"] = c.serve_readings(probs, c.served)[0]
            line["served"] = len(c.served)
            line["control_fp8"] = c.serve_readings(
                probs, c.control_masks(ref.fp8_round))[0]
        line["total_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del c
        cells._free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
