"""The serving slice end to end: ``mcmda_tpu.cli predict`` against
``mcmda_tpu_torch.cli predict --device cpu`` on the same checkpoints and
volumes.

The checkpoints are npz files in the JAX package's own layout (its
``_flatten`` of a ``SourceState`` / ``AdaptState``), with seeded weights, a
perturbed DAM and target BN.  In f32 the masks must be identical up to
argmax near-ties (at most 0.01% of voxels, reported); under ``eval_bf16``
the frameworks round bf16 at different places, so 99% agreement is asked.
"""

import os

import jax
import numpy as np
import pytest

from mcmda_tpu import cli as jcli
from mcmda_tpu import config as jcfg
from mcmda_tpu.data import synthetic
from mcmda_tpu.data import volumes as jvol
from mcmda_tpu.train import adapt, source
from mcmda_tpu.utils.checkpoint import _flatten
from mcmda_tpu_torch import cli as tcli
from mcmda_tpu_torch.data import volumes as tvol

STAGES = (
    jcfg.StageSpec("stem", 8, 1, 1, 1),
    jcfg.StageSpec("rm1", 8, 2, 1, 2),
    jcfg.StageSpec("rm2", 16, 2, 1, 2),
    jcfg.StageSpec("rm3", 16, 2, 1, 1),
    jcfg.StageSpec("rm4", 24, 1, 2, 2),
    jcfg.StageSpec("rm5", 24, 1, 4, 1),
)


def _config(dam_ema=0.0):
    return jcfg.ExperimentConfig(
        segmenter=jcfg.SegmenterConfig(stages=STAGES, thin_layout="nhwc"),
        critic=jcfg.CriticConfig(taps=("rm4", "rm5"), compress_features=8,
                                 widths=(8, 16), strides=(2, 1)),
        data=jcfg.DataConfig(slice_size=32, batch_size=4),
        adapt=jcfg.AdaptConfig(plug_depth="rm2", dam_ema=dam_ema),
        run=jcfg.RunConfig(eval_postprocess="cc"))


def _fill(flat, prefix, rng, scale=None):
    """Seeded values for every key under ``prefix``: He-normal convs,
    BN scale in [0.5, 1], running var in [1, 3], small biases and means;
    with ``scale``, multiply the existing values by 1 + scale * N(0,1)."""
    for k, v in flat.items():
        if not k.startswith(prefix + "["):
            continue
        if scale is not None:
            flat[k] = (v * (1 + scale * rng.standard_normal(v.shape))) \
                .astype(np.float32)
        elif k.endswith("['w']"):
            flat[k] = (rng.standard_normal(v.shape)
                       * np.sqrt(2.0 / np.prod(v.shape[:-1]))) \
                .astype(np.float32)
        elif k.endswith("['scale']"):
            flat[k] = rng.uniform(0.5, 1.0, v.shape).astype(np.float32)
        elif k.endswith("['var']"):
            flat[k] = rng.uniform(1.0, 3.0, v.shape).astype(np.float32)
        else:
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    cfg = _config()
    src = _flatten(source.init_state(jax.random.key(0), cfg))
    _fill(src, ".params", rng)
    _fill(src, ".bn_state", rng)
    os.makedirs(root / "src")
    np.savez(root / "src" / "step_00000010.npz", **src)

    ckpts = {"src": str(root / "src")}
    for name, ema in (("ada", 0.0), ("ada_ema", 0.5)):
        cfg_a = _config(dam_ema=ema)
        s0 = source.init_state(jax.random.key(0), cfg_a)
        flat = _flatten(adapt.init_state(jax.random.key(1), cfg_a, s0.params,
                                         s0.bn_state))
        for field, from_field in (("src_params", ".params"),
                                  ("src_bn", ".bn_state"),
                                  ("dam_params", ".params"),
                                  ("tgt_bn", ".bn_state")):
            for k in flat:
                if k.startswith("." + field + "["):
                    flat[k] = src[from_field + k[len(field) + 1:]]
        _fill(flat, ".dam_params", rng, scale=0.1)
        _fill(flat, ".tgt_bn", rng, scale=0.1)
        if ema:
            _fill(flat, ".avg_dam", rng)
            _fill(flat, ".avg_bn", rng)
            flat[".ema_w"] = np.float32(0.4)
        path = root / name / "step_00000020.npz"
        os.makedirs(path.parent)
        np.savez(path, **flat)
        ckpts[name] = str(path)[:-4]

    vin = root / "in"
    vin.mkdir()
    vol, _ = synthetic.make_volume(rng, "ct", depth=6, size=32)
    jvol.save_nifti(str(vin / "case1.nii.gz"), vol * 40.0 + 100.0,
                    np.array([2.0, 1.0, 1.0]))
    vol2, _ = synthetic.make_volume(rng, "mri", depth=5, size=32)
    jvol.save_volume(str(vin / "case2.npz"), vol2)
    cfg_path = root / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    return dict(root=root, ckpts=ckpts, inp=str(vin), cfg=str(cfg_path))


CASES = {
    # name: (checkpoint, extra CLI args, min agreement)
    "source_fused_f32": ("src", ["--source-only", "--postprocess", "none",
                                 "--set", "run.use_pallas=true"], None),
    "adapted_fused_f32_flip_cc": ("ada", ["--tta", "flip", "--set",
                                          "run.use_pallas=true"], None),
    "adapted_fused_bf16_flip_cc": ("ada", ["--tta", "flip", "--set",
                                           "run.use_pallas=true", "--set",
                                           "run.eval_bf16=true"], 0.99),
    "adapted_plain_avg_weights": ("ada_ema", ["--weights", "avg", "--set",
                                              "adapt.dam_ema=0.5"], None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_predict_matches_jax_cli(served, case, capsys):
    ckpt, extra, min_agree = CASES[case]
    common = ["predict", "--config", served["cfg"], "--ckpt",
              served["ckpts"][ckpt], "--input", served["inp"], *extra]
    out_j = str(served["root"] / f"jax_{case}")
    out_t = str(served["root"] / f"torch_{case}")
    assert jcli.main(common + ["--out", out_j]) == 0
    assert tcli.main(common + ["--out", out_t, "--device", "cpu"]) == 0

    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == \
        ["case1_pred.nii.gz", "case2_pred.npz"]
    report = {}
    for name in ("case1_pred.nii.gz", "case2_pred.npz"):
        mj, sj = jvol.load_volume_with_spacing(os.path.join(out_j, name))
        mt, st = tvol.load_volume_with_spacing(os.path.join(out_t, name))
        assert mt.shape == mj.shape and mt.dtype == mj.dtype
        np.testing.assert_array_equal(st, sj)
        assert set(np.unique(mt).tolist()) <= set(range(5))
        report[name] = int((mt != mj).sum())
        if min_agree is None:
            assert report[name] <= int(1e-4 * mt.size), report
        else:
            assert 1 - report[name] / mt.size >= min_agree, report
    np.testing.assert_array_equal(
        tvol.load_volume_with_spacing(
            os.path.join(out_t, "case1_pred.nii.gz"))[1], [2.0, 1.0, 1.0])
    with capsys.disabled():
        print(f"\n{case}: voxels differing from the JAX CLI {report}")
