"""The reference agrees with the port's plain CPU path at a small size:
the tree layout, the augmentation warp, the train forward, T1's loss and
gradients, Adam, one adaptation step and the serving forward."""

import dataclasses

import pytest
import torch

from benchmark import generator
from benchmark.reference import pnp_adanet as ref
from benchmark.reference import train as ref_train
from mcmda_tpu_torch import config as config_mod
from mcmda_tpu_torch.data import pipeline
from mcmda_tpu_torch.models import critic as critic_mod
from mcmda_tpu_torch.models import segmenter
from mcmda_tpu_torch.train import adapt as adapt_mod
from mcmda_tpu_torch.train import source as source_mod

DATA = {"batch_size": 2, "num_classes": 5, "rotate_degrees": 15.0,
        "zoom_range": (0.9, 1.1), "shift_pixels": 10.0}


def _cfg(**run):
    cfg = config_mod.ExperimentConfig()
    return dataclasses.replace(
        cfg, segmenter=dataclasses.replace(cfg.segmenter,
                                           train_fused="pallas"),
        data=dataclasses.replace(cfg.data, warp="pallas", batch_size=2),
        run=dataclasses.replace(cfg.run, **run))


def _close(a, b, tol):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1e-6)


def test_tree_layout_is_the_programs():
    params, state = segmenter.init(config_mod.SegmenterConfig())
    p, s = ref.segmenter_shapes()
    assert {k: tuple(v.shape) for k, v in ref.flat(params).items()} == p
    assert {k: tuple(v.shape) for k, v in ref.flat(state).items()} == s
    cp = critic_mod.init(config_mod.CriticConfig(),
                         config_mod.SegmenterConfig())
    assert {k: tuple(v.shape) for k, v in ref.flat(cp).items()} == \
        ref.critic_shapes()


def test_batch_draw_and_warp():
    cfg = _cfg()
    images = torch.randn(6, 32, 32, 3)
    labels = torch.randint(0, 5, (6, 32, 32), dtype=torch.int32)
    g1 = torch.Generator().manual_seed(5)
    b = pipeline.sample_device_batch(
        {"images": images, "labels": labels.to(torch.int8)}, g1, 2, 5)
    im, lab = pipeline.augment_batch(g1, b["image"], b["label"], cfg.data)
    im2, lab2 = ref_train.source_batch(torch.Generator().manual_seed(5),
                                       images, labels, DATA)
    assert torch.equal(im, im2)
    assert _close(lab, lab2, 1e-6)


def test_t1_loss_gradients_and_adam():
    cfg = _cfg()
    params, bn = generator.segmenter_init(3, 1, "cpu")
    image = torch.randn(2, 32, 32, 3)
    onehot = torch.nn.functional.one_hot(
        torch.randint(0, 5, (2, 32, 32)), 5).float()
    loss, parts, new_bn, grads = source_mod.value_and_grad(
        ref.nest(params), ref.nest(bn), image, onehot, cfg)
    rl, rx, rd, rg, rbn = ref_train.source_grads(params, ref.nest(bn), image,
                                                 onehot)
    assert _close(loss, rl, 1e-5) and _close(parts["dice_loss"], rd, 1e-5)
    g = ref.flat(grads)
    assert all(_close(g[k], rg[k], 1e-3) for k in rg)
    tx = source_mod.make_tx(cfg)
    upd, _ = tx.update(grads, tx.init(ref.nest(params)), ref.nest(params))
    adam = ref.Adam(cfg.source.lr, cfg.source.beta1, cfg.source.beta2,
                    cfg.source.steps, cfg.source.lr_schedule)
    # the same gradients to both: Adam's first step is lr * sign(g)
    new, _ = adam.step(params, g, adam.init(params))
    u = ref.flat(upd)
    assert all(_close(params[k] + u[k], new[k], 1e-6) for k in new)


@pytest.mark.parametrize("bf16,tta", [(True, True), (False, False)])
def test_serving_forward(bf16, tta):
    cfg = config_mod.eval_view(_cfg(eval_bf16=bf16, use_pallas=True))
    params, dam, bn = generator.serving_state(4, "rm2", "cpu")
    x = torch.randn(2, 32, 32, 3)
    _, probs = segmenter.apply_fused_eval(
        ref.nest(params), ref.nest(bn), x, cfg.segmenter,
        dam_params=ref.nest(dam), plug_depth="rm2", use_kernel=False)
    got = ref.serve_forward(ref.nest(params), ref.nest(bn), x,
                            dtype=torch.bfloat16 if bf16 else torch.float32,
                            dam=ref.nest(dam), plug_depth="rm2")
    assert got.dtype == probs.dtype
    assert _close(probs, got, 1e-2 if bf16 else 1e-5)


def test_one_adaptation_step():
    """At 128 x 128 the critic's last instance norm sees 2 x 2 patches, so
    its gradients are not zero."""
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, adapt=dataclasses.replace(
        cfg.adapt, plug_depth="rm2", d_acc_cap=0.75, gan_loss="lsgan",
        src_feats_bf16=True))
    params, bn = generator.segmenter_init(6, 1, "cpu")
    critic = generator.critic_init(6, 2, "cpu")
    state = adapt_mod.init_state(0, cfg, ref.nest(params), ref.nest(bn))
    tx_g, tx_d = adapt_mod.make_txs(cfg)
    state = dataclasses.replace(state, critic_params=ref.nest(critic),
                                opt_d_state=tx_d.init(ref.nest(critic)))
    x_s, x_t = torch.randn(2, 128, 128, 3), torch.randn(2, 128, 128, 3)
    step = adapt_mod.make_adapt_step(cfg, augment=False)
    new, m = step(state, {"src_image": x_s, "tgt_image": x_t}, 0)
    names = ("stem", "rm1", "rm2")
    dam = {k: v.clone() for k, v in params.items() if k[0] in names}
    a = cfg.adapt
    adam_d = ref.Adam(a.lr_d, a.beta1, a.beta2, a.steps, a.lr_schedule)
    st = {"src_params": ref.nest(params), "src_bn": ref.nest(bn),
          "tgt_bn": ref.nest(bn), "dam": dam, "critic": critic,
          "adam_d": adam_d, "opt_d": adam_d.init(critic)}
    _, crit, _, gg, _, rm = ref_train.adapt_grads(
        st, x_s, x_t, {"plug_depth": "rm2", "d_acc_cap": 0.75})
    for k in ("d_loss", "g_loss", "d_acc"):
        assert _close(m[k], rm[k], 1e-5)
    # the DAM's gradient as the optimiser got it: mu = (1 - b1) g
    mu = ref.flat(new.opt_g_state[0].mu)
    assert all(_close(mu[k] / (1 - a.beta1), gg[k], 1e-3) for k in gg)
    assert sum(float(g.abs().max()) > 0 for g in gg.values()) > len(gg) // 2
    c = ref.flat(new.critic_params)
    assert all(_close(c[k], crit[k], 1e-5) for k in crit)
