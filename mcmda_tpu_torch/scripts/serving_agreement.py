"""Voxel agreement of the fused-kernel and the plain serving paths on one
checkpoint, in the shipped bf16 serving precision and in f32.

Both paths run ``run.use_pallas``'s fused eval forward on the same
weights and volumes: one launches the hand-written fused conv kernel, the
other its plain PyTorch version (``use_kernel=False``).  The volumes are the
held-out synthetic target test volumes of ``--direction``, as ``evaluate
--synthetic`` reads them::

    python -m mcmda_tpu_torch.scripts.serving_agreement \\
        --config configs/mri2ct.json --ckpt runs/torch_synthetic/mri2ct/adapt \\
        [--source-only] [--json-out agreement.json]

For each precision it prints the fraction of voxels whose label agrees,
before and after the configured post-processing, and the number that
differ.
"""

from __future__ import annotations

import argparse
import json
import sys

from mcmda_tpu_torch import api, cli, config as config_mod
from mcmda_tpu_torch.data import splits
from mcmda_tpu_torch.evaluation import inference
from mcmda_tpu_torch.utils import device as device_mod

PRECISIONS = {"bf16": "run.eval_bf16=true", "f32": "run.eval_bf16=false"}


def masks(cfg, args, device, use_kernel: bool):
    """(raw, post-processed) label volumes of the test volumes."""
    fwd, pp = api._serving(
        cfg, cli._restore_eval_forward(cfg, args, device, use_kernel),
        None, None)
    raw, post = [], []
    for vol in args.volumes:
        pred = inference.predict_volume(fwd, vol,
                                        context=cfg.data.context_slices,
                                        batch_size=cfg.data.batch_size,
                                        device=device)
        raw.append(pred)
        post.append(pred if pp is None else pp(pred, splits.STRUCTURES))
    return raw, post


def agreement(a, b) -> dict:
    differ = int(sum(int((x != y).sum()) for x, y in zip(a, b)))
    total = int(sum(x.size for x in a))
    return {"agreement": 1.0 - differ / total, "differ": differ,
            "voxels": total}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--direction", default="mri2ct",
                   choices=["mri2ct", "ct2mri"])
    p.add_argument("--synthetic-volumes", type=int, default=4)
    p.add_argument("--ckpt", required=True,
                   help="run dir (resolves selection.json) or step path")
    p.add_argument("--source-only", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json-out", default=None)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    args.synthetic, args.weights = True, "auto"
    device = device_mod.resolve(args.device)
    args.ckpt = cli._resolve_ckpt(args.ckpt)
    base = config_mod.load_config(args.config)
    _, _, (args.volumes, _) = cli._get_data(args, base)
    out = {"ckpt": args.ckpt, "source_only": args.source_only,
           "card": device_mod.card() if device.type == "cuda" else None,
           "settings": device_mod.settings()}
    for prec, ov in PRECISIONS.items():
        cfg = config_mod.load_config(args.config,
                                     ["run.use_pallas=true", ov])
        k_raw, k_post = masks(cfg, args, device, True)
        p_raw, p_post = masks(cfg, args, device, False)
        out[prec] = {"raw": agreement(k_raw, p_raw),
                     "served": agreement(k_post, p_post)}
        r, s = out[prec]["raw"], out[prec]["served"]
        print(f"agreement {prec}: kernel/plain {s['agreement']:.6f} of "
              f"served voxels ({s['differ']} of {s['voxels']} differ), "
              f"{r['agreement']:.6f} before post-processing "
              f"({r['differ']} differ)", flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
