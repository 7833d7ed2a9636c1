"""Plug-depth ablation on the PyTorch port: the twin of
``scripts/ablate_plug_depth.py`` (the paper's study of WHERE to plug the
DAM, early vs middle; middle was best).

Trains one source segmenter on the synthetic cross-modality set
(``configs/smoke.json`` at 64 px, 16-slice volumes), then runs the critic
pretrain and the adversarial adaptation at each requested plug depth and
reports the adapted target Dice per depth::

    python -m mcmda_tpu_torch.scripts.ablate_plug_depth [--device cpu] \\
        [--depths rm1,rm2,rm3] [--source-steps N] [--pretrain-steps N] \\
        [--adapt-steps N]

The steps, feeds and evaluation are the port's own (``train/source.py``,
``train/adapt.py``, ``train/loop.py``, ``api.evaluate``); ``run`` takes
the source state, so a caller may hand it one trained elsewhere.
``--device`` defaults to ``cuda``; a missing GPU is an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from mcmda_tpu_torch import api, config as cm
from mcmda_tpu_torch.data import pipeline, synthetic, volumes as vio
from mcmda_tpu_torch.train import adapt, loop, source
from mcmda_tpu_torch.utils import device as device_mod

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZE, DEPTH = 64, 16


def build_config(source_steps: int, adapt_steps: int,
                 pretrain_steps: int) -> cm.ExperimentConfig:
    """``configs/smoke.json`` with the run lengths of the command line."""
    base = cm.load_config(os.path.join(ROOT, "configs", "smoke.json"))
    return dataclasses.replace(
        base,
        source=dataclasses.replace(base.source, steps=source_steps),
        adapt=dataclasses.replace(base.adapt, steps=adapt_steps,
                                  pretrain_steps=pretrain_steps))


def make_data(size: int = SIZE, depth: int = DEPTH):
    """(mri volumes, mri labels, ct volumes, ct labels): 4 phantoms per
    domain; the first 3 train, the last is the test volume."""
    mri_v, mri_l = synthetic.make_dataset(0, "mri", 4, depth, size)
    ct_v, ct_l = synthetic.make_dataset(0, "ct", 4, depth, size)
    return mri_v, mri_l, ct_v, ct_l


def train_source(cfg, data, device) -> source.SourceState:
    """The one source run all depths adapt from (labelled MRI)."""
    mri_v, mri_l, _, _ = data
    mri_ds = vio.volumes_to_slices(mri_v[:3], mri_l[:3])
    state = source.init_state(0, cfg, device)
    feed = pipeline.prefetch_to_device(iter(pipeline.BatchSampler(
        mri_ds, cfg.data.batch_size, seed=1, num_classes=5)), device=device)
    state, _ = loop.run(source.make_train_step(cfg), state, feed,
                        cfg.source.steps, log_every=0)
    return state


def run(cfg, source_state, depths, data=None) -> tuple[float, dict]:
    """No-adapt target Dice of ``source_state``, then critic pretrain +
    adaptation from it at each plug depth in ``depths``; prints the
    reference script's lines and returns (no-adapt Dice, {depth: adapted
    Dice}).  Runs on the device of ``source_state``."""
    mri_v, mri_l, ct_v, ct_l = data if data is not None else make_data()
    device = source_state.step.device
    no_adapt = api.evaluate(cfg, source_state, ct_v[3:],
                            ct_l[3:])["mean"]["dice"]
    print(f"no-adapt CT mean Dice: {no_adapt:.3f}", flush=True)

    mri_ds = vio.volumes_to_slices(mri_v[:3], mri_l[:3])
    ct_ds = vio.volumes_to_slices(ct_v[:3])
    results = {}
    for depth in depths:
        c = dataclasses.replace(cfg, adapt=dataclasses.replace(
            cfg.adapt, plug_depth=depth))
        a_state = adapt.init_state(2, c, source_state.params,
                                   source_state.bn_state)
        src_s = iter(pipeline.BatchSampler(mri_ds, c.data.batch_size,
                                           seed=3))
        tgt_s = iter(pipeline.BatchSampler(ct_ds, c.data.batch_size,
                                           seed=4))
        pairs = ({"src_image": a["image"], "tgt_image": b["image"]}
                 for a, b in zip(src_s, tgt_s))
        feed = pipeline.prefetch_to_device(pairs, device=device)
        a_state, _ = loop.run(adapt.make_adapt_step(c, train_g=False),
                              a_state, feed, c.adapt.pretrain_steps,
                              log_every=0)
        a_state, _ = loop.run(adapt.make_adapt_step(c), a_state, feed,
                              c.adapt.steps, log_every=0)
        d = api.evaluate(c, a_state, ct_v[3:], ct_l[3:])["mean"]["dice"]
        results[depth] = d
        print(f"plug_depth={depth}: adapted CT mean Dice {d:.3f} "
              f"(gain {d - no_adapt:+.3f})", flush=True)
    if results:
        best = max(results, key=results.get)
        print(f"\nbest depth: {best} ({results[best]:.3f})", flush=True)
    return no_adapt, results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--depths", default="rm1,rm2,rm3")
    p.add_argument("--source-steps", type=int, default=400)
    p.add_argument("--adapt-steps", type=int, default=300)
    p.add_argument("--pretrain-steps", type=int, default=60)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_mod.resolve(args.device, deterministic=True)
    cfg = build_config(args.source_steps, args.adapt_steps,
                       args.pretrain_steps)
    data = make_data()
    run(cfg, train_source(cfg, data, device), args.depths.split(","), data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
