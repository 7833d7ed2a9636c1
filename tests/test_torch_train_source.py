"""Source training (T1) in the port against the JAX package, on the CPU.

Same numpy-seeded weights, BN statistics and batches go through both:
train-mode BN, the losses, the train-mode forward (logits, probs, taps,
new BN state), one train step's gradients, the Adam / AdamW update and the
cosine schedule, checkpoints in both directions, and ``train-source`` ->
``predict`` through the port's CLI.

Tolerances: f32 forward and BN state atol 2e-5; gradients rtol 1e-4 (of
the largest gradient of each tensor); optimizer updates atol 1e-6 on
updates of size ~lr = 1e-3.  Post-step params are not compared elementwise:
Adam's first step is about lr * sign(g), and where |g| is at rounding
level the sign may differ between the packages, a 2 lr difference that
means nothing; the update is checked on identical injected gradients
instead.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcmda_tpu import config as jcfg
from mcmda_tpu.models import segmenter as jseg
from mcmda_tpu.ops import layers as jlayers
from mcmda_tpu.ops import losses as jlosses
from mcmda_tpu.train import source as jsource
from mcmda_tpu.utils import checkpoint as jckpt
from mcmda_tpu_torch import cli as tcli
from mcmda_tpu_torch import config as tcfg
from mcmda_tpu_torch import weights
from mcmda_tpu_torch.data import synthetic, volumes
from mcmda_tpu_torch.models import segmenter as tseg
from mcmda_tpu_torch.ops import layers, losses
from mcmda_tpu_torch.train import loop, optim, source
from mcmda_tpu_torch.utils import checkpoint

ATOL = 2e-5
# a loss over a whole train-mode forward: batch-statistic BN computes its
# variance as E[x^2] - E[x]^2, which cancels, so the two frameworks'
# summation orders reach the loss at ~1e-5 relative
LOSS_RTOL = 1e-4


def _t(tree):
    """numpy / jax tree -> torch tree (copies)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _close(got, want, atol=ATOL, rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], atol, rtol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def _random_trees(cfg, seed):
    """Seeded numpy params (He-normal convs, perturbed BN affine) and
    non-trivial BN statistics in the JAX package's tree layout."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jseg.init(jax.random.key(0), cfg))

    def fill(kp, leaf):
        name = jax.tree_util.keystr(kp)
        if name.endswith("['w']"):
            a = rng.standard_normal(leaf.shape) * np.sqrt(
                2.0 / np.prod(leaf.shape[:-1]))
        elif name.endswith("['scale']"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif name.endswith("['var']"):
            a = rng.uniform(0.5, 2.0, leaf.shape)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(seed, n, size, k=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    # blobs of classes, so the Dice terms are not degenerate
    lab = (np.arange(size)[None, :, None] // (size // 4)
           + np.arange(size)[None, None, :] // (size // 2)
           + rng.integers(0, 2, (n, 1, 1))) % k
    return x, np.eye(k, dtype=np.float32)[lab]


def _port_cfg(cfg):
    return tcfg.ExperimentConfig.from_json(cfg.to_json())


# --------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_apply_train_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (2 + 3 * rng.normal(size=(3, 5, 4, 6))).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 6), "bias": rng.normal(size=6)}
    st = {"mean": rng.normal(size=6), "var": rng.uniform(0.5, 2, 6)}
    p, st = ({k: v.astype(np.float32) for k, v in d.items()} for d in (p, st))
    jy, jst = jlayers.bn_apply(jax.tree.map(jnp.asarray, p),
                               jax.tree.map(jnp.asarray, st),
                               jnp.asarray(x).astype(dtype), train=True,
                               momentum=0.9, eps=1e-3)
    ty, tst = layers.bn_apply_train(_t(p), _t(st),
                                    torch.from_numpy(x).to(
                                        tcfg.torch_dtype(dtype)),
                                    momentum=0.9, eps=1e-3)
    assert str(ty.dtype) == f"torch.{dtype}"
    atol = ATOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), atol=atol)
    _close(tst, jst)


def test_upsample_cached_in_inference_mode_still_trains():
    """A serving call (inference mode) first builds and caches the upsample
    weights; a training forward after it must still differentiate."""
    x = torch.randn(2, 3, 5, 4)
    with torch.inference_mode():
        want = layers.bilinear_upsample(x, 8)
    xg = x.clone().requires_grad_()
    y = layers.bilinear_upsample(xg, 8)
    (g,) = torch.autograd.grad(y.sum(), xg)
    assert torch.equal(y.detach(), want)
    torch.testing.assert_close(g, torch.full_like(x, 64.0))


@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(weighted):
    rng = np.random.default_rng(1)
    logits = (2 * rng.normal(size=(2, 8, 8, 5))).astype(np.float32)
    _, lab = _batch(2, 2, 8)
    cw = (0.1, 0.2, 0.3, 0.2, 0.2) if weighted else None
    jl = jnp.asarray(logits)
    jtot, jparts = jlosses.segmentation_loss(
        jl, jax.nn.softmax(jl, -1), jnp.asarray(lab), 0.7, 1.3, cw)
    tl = torch.from_numpy(logits)
    ttot, tparts = losses.segmentation_loss(
        tl, torch.softmax(tl, -1), torch.from_numpy(lab), 0.7, 1.3, cw)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-5)
    for k in ("xent", "dice_loss"):
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-5)


# ------------------------------------------------------- forward + step
FUSED_STAGES = (
    jcfg.StageSpec("stem", 8, 1, 1, 1),
    jcfg.StageSpec("rm1", 8, 2, 1, 1),
    jcfg.StageSpec("rm2", 16, 2, 1, 1),
    jcfg.StageSpec("rm3", 128, 2, 1, 1),
    jcfg.StageSpec("rm4", 128, 1, 2, 1),
)


def _model_cfg(tiny_config, fused):
    if not fused:
        return tiny_config
    return dataclasses.replace(tiny_config, segmenter=dataclasses.replace(
        tiny_config.segmenter, stages=FUSED_STAGES, train_fused="pallas"))


@pytest.mark.parametrize("fused", [False, True])
def test_train_forward_matches_jax(tiny_config, fused):
    """logits, probs, every tap and the new BN state of the train-mode
    forward.  ``fused``: a 128-wide tail with train_fused="pallas" (the JAX
    kernel in interpret mode, the port's conv + moments path on the
    CPU)."""
    cfg = _model_cfg(tiny_config, fused)
    params, bn = _random_trees(cfg.segmenter, 3)
    x, _ = _batch(4, 2, 32)
    with pltpu.force_tpu_interpret_mode():
        jl, jp, jtaps, jbn = jax.jit(lambda p, s, a: jseg.apply(
            p, s, a, cfg.segmenter, train=True))(params, bn, jnp.asarray(x))
    tl, tp, ttaps, tbn = tseg.apply(_t(params), _t(bn), torch.from_numpy(x),
                                    _port_cfg(cfg).segmenter, train=True)
    _close(tl, jl, atol=1e-4 if fused else ATOL)
    _close(tp, jp)
    _close(ttaps, jtaps, atol=1e-4 if fused else ATOL)
    _close(tbn, jbn)


def _jax_grads(params, bn, x, lab, cfg):
    def loss_fn(p):
        logits, probs, _, new_bn = jseg.apply(p, bn, x, cfg.segmenter,
                                              train=True)
        loss, parts = jlosses.segmentation_loss(
            logits, probs, lab, cfg.source.xent_weight,
            cfg.source.dice_weight, cfg.source.class_weights)
        return loss, (new_bn, parts)

    with pltpu.force_tpu_interpret_mode():
        (loss, (new_bn, parts)), g = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    return loss, parts, new_bn, g


@pytest.mark.parametrize("fused", [False, True])
def test_t1_gradients_match_jax(tiny_config, fused):
    """One T1 step (no augmentation) from an identical state and batch:
    the loss, its parts, the new BN state and every gradient."""
    cfg = _model_cfg(tiny_config, fused)
    params, bn = _random_trees(cfg.segmenter, 5)
    x, lab = _batch(6, 2, 32)
    jloss, jparts, jbn, jg = _jax_grads(params, bn, jnp.asarray(x),
                                        jnp.asarray(lab), cfg)
    tloss, tparts, tbn, tg = source.value_and_grad(
        _t(params), _t(bn), torch.from_numpy(x), torch.from_numpy(lab),
        _port_cfg(cfg))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=LOSS_RTOL)
    _close(tbn, jbn)
    for kp, want in jax.tree_util.tree_flatten_with_path(jg)[0]:
        got = tg
        for key in kp:
            got = got[key.key]
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(kp))


@pytest.fixture(scope="module")
def t1(tiny_config):
    """A JAX and a port SourceState from identical weights under the cosine
    schedule, each before and after one step (no augmentation) on the same
    batch, with the step's metrics."""
    cfg = dataclasses.replace(tiny_config, source=dataclasses.replace(
        tiny_config.source, lr_schedule="cosine"))
    params, bn = _random_trees(cfg.segmenter, 7)
    x, lab = _batch(8, 2, 32)
    j0 = jsource.SourceState(
        params=params, bn_state=bn,
        opt_state=jsource.make_tx(cfg).init(params),
        step=jnp.zeros((), jnp.int32))
    j1, jm = jax.jit(jsource.make_train_step(cfg, augment=False))(
        j0, {"image": jnp.asarray(x), "label": jnp.asarray(lab)},
        jax.random.key(0))
    t_cfg = _port_cfg(cfg)
    t0 = dataclasses.replace(source.init_state(0, t_cfg, "cpu"),
                             params=_t(params), bn_state=_t(bn))
    t1_, tm = source.make_train_step(t_cfg, augment=False)(
        t0, {"image": torch.from_numpy(x), "label": torch.from_numpy(lab)},
        0)
    return dict(cfg=cfg, t_cfg=t_cfg, params=params, j1=j1, jm=jm, t0=t0,
                t1=t1_, tm=tm)


def test_t1_step_matches_jax_step(t1):
    """The whole step function (augment=False): loss metrics, new BN state,
    step count and the optimizer counts advance as the JAX step's."""
    jnew, tnew = t1["j1"], t1["t1"]
    for k in t1["jm"]:
        np.testing.assert_allclose(float(t1["tm"][k]), float(t1["jm"][k]),
                                   rtol=LOSS_RTOL)
    _close(tnew.bn_state, jnew.bn_state)
    assert int(tnew.step) == int(jnew.step) == 1
    for i in (0, 1):  # Adam's count and the schedule's
        assert int(tnew.opt_state[i].count) == \
            int(jnew.opt_state[i].count) == 1
    # the step did not update its input state in place
    _close(t1["t0"].params, t1["params"], atol=0)


@pytest.mark.parametrize("wd,schedule", [(0.0, "constant"), (0.0, "cosine"),
                                         (1e-4, "cosine")])
def test_adam_update_matches_optax(wd, schedule):
    """Three updates on identical injected gradients: updates, moments and
    counts."""
    rng = np.random.default_rng(9)
    params = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "b": rng.normal(size=(5,)).astype(np.float32)}
    jtx = jsource.optim.make_optimizer(1e-3, 0.9, 0.999, wd, schedule, 10)
    ttx = optim.Optimizer(1e-3, 0.9, 0.999, wd, schedule, 10)
    jp, tp = jax.tree.map(jnp.asarray, params), _t(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape)
                                    * 10.0 ** -i).astype(np.float32), params)
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = ttx.update(_t(g), ts, tp)
        _close(tu, ju, atol=1e-6)
        jp = optax.apply_updates(jp, ju)
        tp = jax.tree.map(lambda a, u: a + u, tp, tu)
    _close(ts[0].mu, js[0].mu, atol=1e-6)
    _close(ts[0].nu, js[0].nu, atol=1e-7)
    assert int(ts[0].count) == int(js[0].count) == 3
    assert len(ts) == len(js)
    if schedule == "cosine":
        assert int(ts[-1].count) == int(js[-1].count) == 3


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(1e-3, 10)
    for t in (0, 1, 5, 10, 11):
        np.testing.assert_allclose(float(optim.cosine_decay(1e-3, 10, t)),
                                   float(sched(t)), rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------- checkpoints
def test_jax_restores_port_checkpoint(t1, tmp_path):
    path = checkpoint.save(str(tmp_path), t1["t1"], step=1)
    assert path == str(tmp_path / "step_00000001")
    assert os.listdir(tmp_path) == ["step_00000001.npz"]
    flat = weights.flatten_state(t1["t1"])
    assert set(flat) == set(jckpt._flatten(t1["j1"]))
    assert ".opt_state[1].count" in flat
    like = jax.eval_shape(lambda: jsource.init_state(jax.random.key(1),
                                                     t1["cfg"]))
    restored = jckpt._flatten(jckpt.restore(path, like))
    for k, v in flat.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
        assert restored[k].dtype == v.dtype, k


def test_port_resumes_jax_checkpoint(t1, tmp_path):
    flat = jckpt._flatten(t1["j1"])
    np.savez(tmp_path / "step_00000001.npz", **flat)
    like = source.init_state(3, t1["t_cfg"], "cpu")
    state, start = loop.maybe_resume(str(tmp_path), like)
    assert start == 1 and int(state.step) == 1
    got = weights.flatten_state(state)
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # and trains on from there
    x, lab = _batch(13, 2, 32)
    state, m = source.make_train_step(t1["t_cfg"], augment=False)(
        state, {"image": torch.from_numpy(x), "label": torch.from_numpy(lab)},
        1)
    assert int(state.opt_state[1].count) == 2 and np.isfinite(float(m["loss"]))


def test_checkpoint_prune_and_shape_check(tiny_config, tmp_path):
    state = source.init_state(0, _port_cfg(tiny_config), "cpu")
    for s in (2, 4, 6, 8):
        checkpoint.save(str(tmp_path), state, step=s)
    checkpoint.prune(str(tmp_path), keep=2, protect=(2,))
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000002.npz", "step_00000006.npz", "step_00000008.npz"]
    assert checkpoint.latest_step(str(tmp_path)) == 8
    other = dataclasses.replace(tiny_config, segmenter=dataclasses.replace(
        tiny_config.segmenter, num_classes=3))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path / "step_00000008"),
                           source.init_state(0, _port_cfg(other), "cpu"))


# ------------------------------------------------------------ evaluation
def test_evaluate_volumes_matches_jax():
    """``val_dice``'s report on the same volumes and the same (fixed,
    thresholding) forward: Dice, ASSD and HD95 per structure."""
    from mcmda_tpu.evaluation import report as jreport
    from mcmda_tpu_torch.evaluation import report

    vols, labs = synthetic.make_dataset(1, "ct", 2, 6, 24)
    edges = np.array([-0.5, 0.0, 0.5, 1.0], np.float32)

    def probs(img, lib):
        cls = (img[..., 1:2] > lib.asarray(edges)).sum(-1)
        return lib.nn.functional.one_hot(cls.long(), 5).float() \
            if lib is torch else jax.nn.one_hot(cls, 5)

    want = jreport.evaluate_volumes(lambda x: probs(x, jnp), vols, labs,
                                    batch_size=4, spacing=(2.0, 1.0, 1.0))
    got = report.evaluate_volumes(lambda x: probs(x, torch), vols, labs,
                                  batch_size=4, spacing=(2.0, 1.0, 1.0),
                                  device="cpu")
    for name in ("AA", "LAC", "LVC", "MYO", "mean"):
        for m in ("dice", "assd", "hd95"):
            np.testing.assert_allclose(got[name][m], want[name][m],
                                       rtol=1e-6, err_msg=f"{name} {m}")
    assert got["mean"]["assd_misses"] == want["mean"]["assd_misses"]


# ---------------------------------------------------------------- feeds
def test_feeds_match_jax_sampler():
    """The host sampler draws the JAX package's batches for a seed, and
    both feeds hand the step f32 images (the phantoms are f64 on the host)
    and one-hot labels."""
    from mcmda_tpu.data import pipeline as jpipe
    from mcmda_tpu.data import volumes as jvol
    from mcmda_tpu_torch.data import pipeline

    vols, labs = synthetic.make_dataset(0, "mri", 2, 8, 16)
    jds = jvol.volumes_to_slices(vols, labs, context=3, drop_empty=True)
    ds = volumes.volumes_to_slices(vols, labs, context=3, drop_empty=True)
    np.testing.assert_array_equal(ds.images, jds.images)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    jit = iter(jpipe.BatchSampler(jds, 4, seed=3, num_classes=5))
    tit = pipeline.prefetch_to_device(iter(pipeline.BatchSampler(
        ds, 4, seed=3, num_classes=5)), device="cpu")
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        for k in ("image", "label"):
            assert tb[k].dtype == torch.float32
            np.testing.assert_array_equal(tb[k].numpy(),
                                          jb[k].astype(np.float32))
    data = pipeline.to_device_arrays(ds, 5, "cpu")
    assert data["labels"].dtype == torch.int8
    b = pipeline.sample_device_batch(data, torch.Generator().manual_seed(0),
                                     4, 5)
    assert tuple(b["image"].shape) == (4, 16, 16, 3)
    assert tuple(b["label"].shape) == (4, 16, 16, 5)
    assert torch.equal(b["label"].sum(-1), torch.ones(4, 16, 16))


# ------------------------------------------------------------------ CLI
def test_train_source_cli_then_predict(tiny_config, tmp_path):
    """train-source on the CPU at a tiny config: checkpoints, metrics and
    val_dice; the final checkpoint is served by the port's predict and
    restored by the JAX package."""
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(tiny_config.to_json())
    out = str(tmp_path / "run")
    argv = ["train-source", "--config", str(cfg_path), "--synthetic",
            "--synthetic-volumes", "2", "--out", out, "--device", "cpu"]
    for kv in ("source.steps=4", "run.ckpt_every=2", "run.log_every=1",
               "data.warp=pallas", "segmenter.train_fused=pallas"):
        argv += ["--set", kv]
    assert tcli.main(argv) == 0
    assert sorted(n for n in os.listdir(out) if n.endswith(".npz")) == [
        "step_00000002.npz", "step_00000004.npz"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    loss = [r["loss"] for r in recs if "loss" in r]
    assert len(loss) == 4 and np.isfinite(loss).all()
    assert [r["step"] for r in recs if "val_dice" in r] == [2]
    # resuming a finished run takes no step and leaves the checkpoint
    assert tcli.main(argv) == 0

    vol, _ = synthetic.make_volume(np.random.default_rng(0), "ct", depth=5,
                                   size=32)
    volumes.save_volume(str(tmp_path / "v.npz"), vol)
    pred = str(tmp_path / "pred")
    assert tcli.main(["predict", "--config", str(cfg_path), "--ckpt", out,
                      "--source-only", "--input", str(tmp_path / "v.npz"),
                      "--out", pred, "--device", "cpu"]) == 0
    mask = volumes.load_volume_with_spacing(
        os.path.join(pred, "v_pred.npz"))[0]
    assert mask.shape == (5, 32, 32)
    assert set(np.unique(mask).tolist()) <= set(range(5))

    like = jax.eval_shape(lambda: jsource.init_state(jax.random.key(0),
                                                     tiny_config))
    restored = jckpt.restore(os.path.join(out, "step_00000004"), like)
    params, _ = weights.restore_source(os.path.join(out, "step_00000004"),
                                       _port_cfg(tiny_config), "cpu")
    _close(params, restored.params, atol=0)
    assert int(restored.step) == 4
