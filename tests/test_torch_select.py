"""Checkpoint selection in the port against the JAX package, on the CPU:
the copied selectors pick the same steps from the same streams, the
class-ratio probe gives the same fractions and entropy (padding rows
masked), ``SelectionProbe``'s deferred bookkeeping, prune with protected
and newest steps, and the PIL-free snapshot PNG."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mcmda_tpu.evaluation import snapshots as jsnap
from mcmda_tpu.models import segmenter as jseg
from mcmda_tpu.train import adapt as jadapt
from mcmda_tpu_torch import config as tcfg
from mcmda_tpu_torch.evaluation import snapshots
from mcmda_tpu_torch.train import adapt
from mcmda_tpu_torch.utils import checkpoint


def _stream(seed, n=25, k=3):
    rng = np.random.default_rng(seed)
    steps = [100 * (i + 1) for i in range(n)]
    return (steps, rng.dirichlet((2.0, 1.0, 0.5)[:k], size=n),
            rng.uniform(0.1, 1.0, size=n), np.array([0.6, 0.3, 0.1][:k]))


@pytest.mark.parametrize("policy,window,topk,warmup", [
    ("cr", 1, 16, 0), ("cr_ent", 1, 4, 300), ("cr", 3, 16, 0),
    ("cr_ent", 3, 8, 500), ("cr_ent", 5, 2, 0)])
def test_class_ratio_selector_replays_jax(policy, window, topk, warmup,
                                          tmp_path):
    """The same fractions / entropy stream (two weight variants) through
    the port's and the JAX package's selectors: the same pick, score,
    variant, reservoir, keep set and selection.json."""
    steps, fracs, ents, ref = _stream(7)
    _, fracs_avg, ents_avg, _ = _stream(8)
    sels = [mod.ClassRatioSelector(ref, warmup_step=warmup, policy=policy,
                                   topk=topk, smooth_window=window)
            for mod in (adapt, jadapt)]
    for s, fr, en, fa, ea in zip(steps, fracs, ents, fracs_avg, ents_avg):
        for sel in sels:
            sel.update(s, fr, ent=float(en))
            sel.update(s, fa, variant="avg", ent=float(ea))
        assert sels[0].keep_steps() == sels[1].keep_steps()
    for sel in sels:
        sel.finalize()
    port, ref_sel = sels
    assert (port.best_step, port.best_variant) == \
        (ref_sel.best_step, ref_sel.best_variant)
    assert port.best_score == ref_sel.best_score
    assert port.reservoir == ref_sel.reservoir
    assert port.ranked() == ref_sel.ranked()
    for i, sel in enumerate(sels):
        d = tmp_path / str(i)
        d.mkdir()
        sel.save(str(d))
    assert json.load(open(tmp_path / "0" / "selection.json")) == \
        json.load(open(tmp_path / "1" / "selection.json"))


def test_equilibrium_selector_and_cr_examples_match_jax(tmp_path):
    """The JAX package's worked examples (``tests/test_train.py``)."""
    trace = [(10, 0.55), (20, 0.95), (30, 0.7), (40, 0.52), (50, 0.9),
             (60, 0.99)]
    for mod in (adapt, jadapt):
        sel = mod.EquilibriumSelector(ema=0.0, warmup_step=20)
        for step, acc in trace:
            sel.update(step, {"d_acc": acc})
        assert sel.best_step == 40
    ref = np.array([0.9, 0.02, 0.02, 0.02, 0.04])
    sel = adapt.ClassRatioSelector(ref, warmup_step=20)
    for step, fr in [(10, [0.90, 0.02, 0.02, 0.02, 0.04]),
                     (20, [0.96, 0.00, 0.01, 0.01, 0.02]),
                     (30, [0.91, 0.02, 0.02, 0.02, 0.03]),
                     (40, [0.99, 0.00, 0.00, 0.00, 0.01])]:
        sel.update(step, fr)
    assert sel.best_step == 30
    sel.save(str(tmp_path))
    rec = json.load(open(tmp_path / "selection.json"))
    assert rec["signal"] == "class_ratio" and rec["weights"] == "live"
    with pytest.warns(UserWarning, match="ent=None"):
        adapt.ClassRatioSelector(np.array([0.5, 0.5]),
                                 policy="cr_ent").update(10, [0.6, 0.4])


def test_selection_helpers_match_jax(tiny_config):
    labs = [np.array([[0, 0], [1, 2]]), np.array([[0, 4], [4, 4]])]
    np.testing.assert_array_equal(adapt.label_fractions(labs, 5),
                                  jadapt.label_fractions(labs, 5))
    for span, every, steps, pre in ((0, 100, 30, 0), (300, 100, 1000, 5),
                                    (300, 250, 40, 0), (500, 100, 9, 2)):
        cfg = dataclasses.replace(tiny_config, adapt=dataclasses.replace(
            tiny_config.adapt, select_smooth_span=span, select_every=every,
            steps=steps, pretrain_steps=pre))
        t_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())
        assert adapt.smooth_window(t_cfg) == jadapt.smooth_window(cfg)
        assert adapt.select_warmup(t_cfg) == jadapt.select_warmup(cfg)


@pytest.mark.parametrize("n_extra", [0, 1, 3])
def test_class_ratio_probe_matches_jax(tiny_config, n_extra):
    """Fractions and mean entropy over probe stacks that need padding
    (b + 1 and b + 3 slices) or none, on identical adapted states; the
    bundle's weight copies are the state's eval weights."""
    cfg = tiny_config
    rng = np.random.default_rng(11)
    src_p, src_bn = jseg.init(jax.random.key(0), cfg.segmenter)
    jstate = jadapt.init_state(jax.random.key(1), cfg, src_p, src_bn)
    jstate = jstate.replace(dam_params=jax.tree.map(
        lambda a: a * (1 + 0.1 * rng.standard_normal(a.shape)).astype(
            np.float32), jstate.dam_params))
    t_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())

    def to_t(tree):
        return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)

    tstate = adapt.init_state(0, t_cfg, to_t(src_p), to_t(src_bn))
    tstate = dataclasses.replace(tstate, dam_params=to_t(jstate.dam_params))
    b = cfg.data.batch_size
    imgs = rng.normal(size=(b + n_extra, 32, 32, 3)).astype(np.float32)
    jf, je = jadapt.make_class_ratio_probe(cfg, imgs)(jstate)
    tf, te = adapt.make_class_ratio_probe(t_cfg, imgs)(tstate)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
    # and directly: the forward's argmax counts over the real slices only
    with torch.no_grad():
        probs = adapt.adapted_forward(t_cfg)(tstate, torch.from_numpy(imgs))
    want = np.bincount(probs.argmax(-1).reshape(-1).numpy(),
                       minlength=5) / probs[..., 0].numel()
    np.testing.assert_allclose(tf.numpy(), want, atol=1e-6)
    out = adapt.make_select_bundle(t_cfg, imgs)(tstate)
    dam, bn = out["weights_live"]
    for x, y in zip(jax.tree.leaves(dam),
                    jax.tree.leaves(tstate.dam_params)):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    assert "fracs_avg" not in out


def test_selection_probe_deferred_bookkeeping(tmp_path):
    """A call reads the previous tick; flush() retires the last; the stash
    holds the best tick's weights; device d_acc reaches the equilibrium
    selector at read time (``tests/test_train.py``)."""
    cr = adapt.ClassRatioSelector(np.array([0.5, 0.5]), warmup_step=0)
    eq = adapt.EquilibriumSelector(ema=0.0, warmup_step=0)

    def bundle(st):
        return {"fracs_live": torch.tensor(st["fracs"]),
                "weights_live": ({"w": torch.full((3,), st["marker"])},
                                 {"m": torch.zeros(1)})}

    probe = adapt.SelectionProbe(bundle, primary=cr, cr_selector=cr,
                                 eq_selector=eq, save_dir=str(tmp_path))
    for step, fracs, marker, dacc in [(10, [0.9, 0.1], 1.0, 0.9),
                                      (20, [0.55, 0.45], 2.0, 0.6),
                                      (30, [0.8, 0.2], 3.0, 0.95)]:
        probe(step, {"fracs": fracs, "marker": marker},
              metrics={"d_acc": torch.tensor(dacc)})
    assert cr.best_step == 20  # tick 30 still pending
    probe.flush()
    assert cr.best_step == 20 and eq.best_step == 20
    torch.testing.assert_close(probe.best_stash["dam_params"]["w"],
                               torch.full((3,), 2.0))
    assert json.load(open(tmp_path / "selection.json"))["best_step"] == 20
    assert probe.protect_steps() == {20}
    probe.flush()  # idempotent with nothing pending


def test_cr_ent_probe_stash_follows_pick(tmp_path):
    """Under cr_ent the stash holds exactly the reservoir, the pick may
    move to an older step, and finalize settles the smoothing tail."""
    cr = adapt.ClassRatioSelector(np.array([0.5, 0.5]), warmup_step=0,
                                  policy="cr_ent", topk=2)

    def bundle(st):
        return {"fracs_live": torch.tensor(st["fracs"]),
                "ent_live": torch.tensor(st["ent"]),
                "weights_live": ({"w": torch.full((2,), st["marker"])},
                                 {"m": torch.zeros(1)})}

    probe = adapt.SelectionProbe(bundle, primary=cr, cr_selector=cr,
                                 save_dir=str(tmp_path))
    for step, fracs, ent, marker in [(10, [0.60, 0.40], 0.30, 1.0),
                                     (20, [0.55, 0.45], 0.90, 2.0),
                                     (30, [0.57, 0.43], 0.10, 3.0),
                                     (40, [0.90, 0.10], 0.01, 4.0)]:
        probe(step, {"fracs": fracs, "ent": ent, "marker": marker})
    probe.finalize()
    assert cr.best_step == 20
    assert probe.protect_steps() == {20, 30}
    assert set(probe._stash) == {(20, "live"), (30, "live")}
    torch.testing.assert_close(probe.best_stash["dam_params"]["w"],
                               torch.full((2,), 2.0))
    rec = json.load(open(tmp_path / "selection.json"))
    assert rec["policy"] == "cr_ent" and len(rec["reservoir"]) == 2


def test_prune_protect_and_newest(tiny_config, tmp_path):
    """prune keeps the newest ``keep`` steps counting ``newest`` (a save
    not yet listed), and every protected step."""
    from mcmda_tpu_torch.train import source

    state = source.init_state(0, tcfg.ExperimentConfig.from_json(
        tiny_config.to_json()), "cpu")
    for s in (5, 10, 15):
        checkpoint.save(str(tmp_path), state, step=s)
    checkpoint.prune(str(tmp_path), keep=2, newest=20)
    assert sorted(os.listdir(tmp_path)) == ["step_00000015.npz"]
    for s in (5, 10, 20):
        checkpoint.save(str(tmp_path), state, step=s)
    checkpoint.prune(str(tmp_path), keep=2, protect={5}, newest=20)
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000005.npz", "step_00000015.npz", "step_00000020.npz"]


def test_snapshot_png_equals_jax_pixel_for_pixel(tmp_path):
    """The standard-library PNG decodes (PIL) to the JAX package's image,
    with and without the ground-truth column."""
    rng = np.random.default_rng(3)
    images = rng.normal(size=(5, 24, 20, 3)).astype(np.float32)
    preds = rng.integers(0, 5, (5, 24, 20))
    truths = rng.integers(0, 7, (5, 24, 20))  # out-of-range labels clip
    for tr in (None, truths):
        a = snapshots.save_snapshot(str(tmp_path / "port" / "s.png"),
                                    images, preds, tr)
        b = jsnap.save_snapshot(str(tmp_path / "jax" / "s.png"), images,
                                preds, tr)
        pa, pb = Image.open(a), Image.open(b)
        assert pa.mode == pb.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
    assert np.asarray(pa).shape == (4 * 24, 3 * 20, 3)
    assert open(a, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
