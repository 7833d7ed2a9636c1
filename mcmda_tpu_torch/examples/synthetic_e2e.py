"""End-to-end PnP-AdaNet workflow on the synthetic cross-modality dataset,
on the PyTorch port: the twin of ``examples/synthetic_e2e.py``.

Drives every driver config from BASELINE.json through the port's modules:
  2: supervised source training (MRI)
  1: source-only inference + Dice eval  (on MRI = sanity, on CT = lower bound)
  3: discriminator pretrain
  4: full adaptation MRI->CT (alternating G/D step)
  then 3D-stitched eval of the adapted net (config 5 machinery)

Small shapes (64x64 slices, 16-slice volumes, stages up to 128) and the
plain paths (no kernel is asked for in the config), as in the JAX
package's example.  Exits 0 iff the source net's MRI Dice is above 0.6 and
adaptation improves the CT Dice over no adaptation.

Usage: python mcmda_tpu_torch/examples/synthetic_e2e.py [--cpu] [--dp N]
"""

import argparse
import os.path
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from mcmda_tpu_torch import config as cm  # noqa: E402
from mcmda_tpu_torch.data import pipeline, synthetic, volumes  # noqa: E402
from mcmda_tpu_torch.evaluation import report  # noqa: E402
from mcmda_tpu_torch.train import adapt, drivers, loop, source  # noqa: E402
from mcmda_tpu_torch.utils import device as device_mod  # noqa: E402
from mcmda_tpu_torch.utils import logging as mlog  # noqa: E402

SIZE, DEPTH = 64, 16


def build_config(source_steps: int, pretrain_steps: int,
                 adapt_steps: int) -> cm.ExperimentConfig:
    stages = (
        cm.StageSpec("stem", 16, 1, 1, 1),
        cm.StageSpec("rm1", 32, 2, 1, 1),
        cm.StageSpec("rm2", 48, 2, 1, 2),
        cm.StageSpec("rm3", 64, 2, 1, 2),
        cm.StageSpec("rm4", 96, 1, 2, 2),
        cm.StageSpec("rm5", 128, 1, 2, 2),
    )
    return cm.ExperimentConfig(
        segmenter=cm.SegmenterConfig(stages=stages),
        critic=cm.CriticConfig(taps=("rm4", "rm5"), compress_features=32,
                               widths=(32, 64), strides=(2, 1)),
        data=cm.DataConfig(slice_size=SIZE, batch_size=8, shift_pixels=4.0,
                           rotate_degrees=10.0),
        source=cm.SourceTrainConfig(lr=1e-3, steps=source_steps),
        adapt=cm.AdaptConfig(plug_depth="rm2", lr_d=2e-4, lr_g=2e-4,
                             steps=adapt_steps,
                             pretrain_steps=pretrain_steps),
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the GPU, else an error)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel over N devices (N > 1 is not "
                        "ported yet and raises)")
    p.add_argument("--source-steps", type=int, default=400)
    p.add_argument("--pretrain-steps", type=int, default=100)
    p.add_argument("--adapt-steps", type=int, default=400)
    args = p.parse_args(argv)

    device = device_mod.resolve("cpu" if args.cpu else "cuda",
                                deterministic=True)
    cfg = build_config(args.source_steps, args.pretrain_steps,
                       args.adapt_steps)
    print(f"device: {device}", flush=True)

    # -------------------------------------------------------------- data
    mri_vols, mri_labs = synthetic.make_dataset(0, "mri", 4, DEPTH, SIZE)
    ct_vols, ct_labs = synthetic.make_dataset(0, "ct", 4, DEPTH, SIZE)
    mri_train = volumes.volumes_to_slices(mri_vols[:3], mri_labs[:3])
    ct_train = volumes.volumes_to_slices(ct_vols[:3])  # unlabeled target
    mri_test_v, mri_test_l = mri_vols[3:], mri_labs[3:]
    ct_test_v, ct_test_l = ct_vols[3:], ct_labs[3:]

    # --------------------------------------------- config 2: source training
    print("\n== config 2: supervised source training (MRI) ==", flush=True)
    state = source.init_state(0, cfg, device)
    step, global_batch, to_device = drivers.wrap_dp(
        cfg, source.make_train_step, args.dp, device=device)
    sampler = iter(pipeline.BatchSampler(mri_train, global_batch, seed=1,
                                         num_classes=5))
    t0 = time.time()
    state, _ = loop.run(step, state, to_device(sampler), cfg.source.steps,
                        seed=0, log_every=100,
                        logger=mlog.MetricsLogger(echo=True))
    dt = time.time() - t0
    print(f"source training: {cfg.source.steps} steps, "
          f"{cfg.source.steps * global_batch / dt:.1f} slices/s", flush=True)

    # -------------------------------------- config 1: source-only inference
    print("\n== config 1: source-only eval ==", flush=True)
    eval_raw = source.make_eval_forward(cfg)

    def fwd(img):
        return eval_raw(state.params, state.bn_state, img)

    agg_mri = report.evaluate_volumes(fwd, mri_test_v, mri_test_l,
                                      batch_size=8, device=device)
    print("source net on MRI (upper-ish bound):")
    print(report.format_table(agg_mri), flush=True)
    agg_ct0 = report.evaluate_volumes(fwd, ct_test_v, ct_test_l,
                                      batch_size=8, device=device)
    print("source net on CT, NO adaptation (lower bound):")
    print(report.format_table(agg_ct0), flush=True)

    # ----------------------------------- configs 3+4: pretrain + adaptation
    print("\n== config 3: discriminator pretrain ==", flush=True)
    a_state = adapt.init_state(2, cfg, state.params, state.bn_state)
    per_host, to_device = drivers.feed_plumbing(cfg, args.dp, device=device)
    src_sampler = iter(pipeline.BatchSampler(mri_train, per_host, seed=3))
    tgt_sampler = iter(pipeline.BatchSampler(ct_train, per_host, seed=4))

    def adapt_feed():
        for sb, tb in zip(src_sampler, tgt_sampler):
            yield {"src_image": sb["image"], "tgt_image": tb["image"]}

    feed_a = to_device(adapt_feed())
    pre_step = adapt.make_adapt_step(cfg, train_g=False)
    ad_step = adapt.make_adapt_step(cfg)
    a_state, _ = loop.run(pre_step, a_state, feed_a,
                          cfg.adapt.pretrain_steps, seed=5, log_every=50,
                          logger=mlog.MetricsLogger(echo=True))

    print("\n== config 4: PnP-AdaNet adaptation MRI->CT ==", flush=True)
    t0 = time.time()
    a_state, _ = loop.run(ad_step, a_state, feed_a, cfg.adapt.steps, seed=6,
                          log_every=100, logger=mlog.MetricsLogger(echo=True))
    dt = time.time() - t0
    print(f"adaptation: {cfg.adapt.steps} steps, "
          f"{cfg.adapt.steps * per_host / dt:.1f} tgt-slices/s", flush=True)

    # ------------------------------------------ adapted eval (config 5 path)
    print("\n== adapted net on CT (3D-stitched Dice/ASSD) ==", flush=True)
    a_raw = adapt.adapted_forward(cfg)
    agg_ct1 = report.evaluate_volumes(lambda img: a_raw(a_state, img),
                                      ct_test_v, ct_test_l, batch_size=8,
                                      device=device)
    print(report.format_table(agg_ct1), flush=True)

    d0 = agg_ct0["mean"]["dice"]
    d1 = agg_ct1["mean"]["dice"]
    dm = agg_mri["mean"]["dice"]
    print(f"\nsummary: MRI dice={dm:.3f}  CT no-adapt={d0:.3f}  "
          f"CT adapted={d1:.3f}  (adaptation gain {d1 - d0:+.3f})")
    ok = dm > 0.6 and d1 > d0
    print("E2E RESULT:", "OK" if ok else "DEGRADED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
