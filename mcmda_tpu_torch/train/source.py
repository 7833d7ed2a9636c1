"""T1: supervised source-segmenter training (counterpart of
``mcmda_tpu/train/source.py``).

One train step: on-device sampling (optional) -> augmentation -> train-mode
forward -> weighted cross-entropy + soft Dice -> Adam.  The state is
functional: the step returns a new ``SourceState`` and never updates the
old one in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mcmda_tpu_torch.config import ExperimentConfig
from mcmda_tpu_torch.data import pipeline
from mcmda_tpu_torch.models import segmenter
from mcmda_tpu_torch.ops import losses
from mcmda_tpu_torch.train import optim
from mcmda_tpu_torch.utils import prng, tree


@dataclasses.dataclass(frozen=True)
class SourceState:
    params: Any
    bn_state: Any
    opt_state: Any
    step: torch.Tensor  # int32 scalar


def make_tx(cfg: ExperimentConfig) -> optim.Optimizer:
    s = cfg.source
    return optim.Optimizer(s.lr, s.beta1, s.beta2, s.weight_decay,
                           s.lr_schedule, s.steps)


def init_state(seed: int, cfg: ExperimentConfig, device) -> SourceState:
    """He-normal params from a generator seeded with ``seed``, identity BN,
    fresh optimizer state, step 0."""
    params, bn_state = segmenter.init(
        cfg.segmenter, generator=prng.generator(seed, device), device=device)
    return SourceState(params=params, bn_state=bn_state,
                       opt_state=make_tx(cfg).init(params),
                       step=torch.zeros((), dtype=torch.int32, device=device))


def value_and_grad(params, bn_state, image, label, cfg: ExperimentConfig):
    """The supervised loss at ``params`` and its gradients (the JAX step's
    ``jax.value_and_grad(loss_fn, has_aux=True)``) -> (loss, {"xent",
    "dice_loss"}, new BN state, grads)."""
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    logits, probs, _, new_bn = segmenter.apply(
        tree.unflatten(params, leaves), bn_state, image, cfg.segmenter,
        train=True)
    src = cfg.source
    loss, parts = losses.segmentation_loss(
        logits, probs, label, src.xent_weight, src.dice_weight,
        src.class_weights)
    grads = tree.unflatten(params, torch.autograd.grad(loss, leaves))
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            new_bn, grads)


def make_train_step(cfg: ExperimentConfig, augment: bool = True,
                    sample_from_device: bool = False):
    """Returns ``step(state, batch, seed) -> (state, metrics)``.

    batch = {"image": [B,H,W,C], "label": [B,H,W,K]} normally; with
    ``sample_from_device`` it is the device-resident dataset of
    ``pipeline.to_device_arrays`` and the step draws its own batch there.
    ``seed`` seeds the step's generator (batch indices, then augmentation
    draws).  Metrics are device scalars."""
    tx = make_tx(cfg)

    def step(state: SourceState, batch, seed: int):
        images = batch["images"] if sample_from_device else batch["image"]
        gen = prng.generator(seed, images.device)
        if sample_from_device:
            batch = pipeline.sample_device_batch(batch, gen,
                                                 cfg.data.batch_size,
                                                 cfg.data.num_classes)
        image, label = batch["image"], batch["label"]
        if augment:
            image, label = pipeline.augment_batch(gen, image, label, cfg.data)
        loss, parts, new_bn, grads = value_and_grad(
            state.params, state.bn_state, image, label, cfg)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            new_params = tree.tree_map(lambda p, u: p + u, state.params,
                                       updates)
        return SourceState(params=new_params, bn_state=new_bn,
                           opt_state=new_opt, step=state.step + 1), \
            {"loss": loss, **parts}

    return step


def make_eval_forward(cfg: ExperimentConfig):
    """Inference forward (eval-mode BN): (params, bn_state, images) ->
    probs."""
    def fwd(params, bn_state, image):
        return segmenter.apply(params, bn_state, image, cfg.segmenter)[1]
    return fwd
