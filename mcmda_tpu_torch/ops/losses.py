"""Losses (counterpart of ``mcmda_tpu/ops/losses.py``): weighted
cross-entropy + multi-class soft Dice for the segmenter, and the
adversarial losses of the feature critic.  All reduce to f32 scalars over
the whole batch.

Under data parallelism the segmentation losses take the process group
``group`` (the JAX ``axis_name``): their numerators and denominators are
global sums over the ranks (``dp.global_sum``, identity backward), so the
loss is the whole batch's and each rank's gradient is its shard's part of
it (summed over the ranks by the T1 step).  The adversarial losses are
per-shard means; the adapt step averages their gradients."""

from __future__ import annotations

import functools

import torch

from mcmda_tpu_torch.parallel import dp


def weighted_cross_entropy(logits, labels_onehot, class_weights=None,
                           group=None):
    """Per-pixel softmax cross-entropy, optionally class-weighted.

    ``class_weights=None`` uses inverse-frequency weights computed from the
    (global) batch -- background pixels dominate cardiac slices ~20:1."""
    logp = torch.log_softmax(logits, dim=-1)
    if class_weights is None:
        freq = dp.global_mean(labels_onehot.mean((0, 1, 2)), group)  # [C]
        class_weights = 1.0 / (freq + 1e-3)
        class_weights = class_weights / class_weights.sum()
    w = (class_weights if isinstance(class_weights, torch.Tensor)
         else _class_weights(tuple(class_weights), logits.device))
    pix_w = (labels_onehot * w).sum(-1)  # [N,H,W]
    xent = -(labels_onehot * logp).sum(-1)
    num = dp.global_sum((pix_w * xent).sum(), group)
    den = dp.global_sum(pix_w.sum(), group)
    return num / (den + 1e-8)


@functools.lru_cache(maxsize=None)
def _class_weights(values: tuple, device) -> torch.Tensor:
    """Configured class weights on ``device``, copied there once: a copy
    from the host inside a step would stop the step's capture as a CUDA
    graph."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def soft_dice_loss(probs, labels_onehot, smooth: float = 1.0,
                   skip_background: bool = True, group=None):
    """Multi-class soft Dice loss over the (global) batch: Dice per class
    over all pixels, averaged over the (foreground) classes; loss = 1 -
    mean Dice."""
    start = 1 if skip_background else 0
    p = probs[..., start:].float()
    t = labels_onehot[..., start:].float()
    inter = dp.global_sum((p * t).sum((0, 1, 2)), group)
    denom = dp.global_sum(p.sum((0, 1, 2)) + t.sum((0, 1, 2)), group)
    dice = (2.0 * inter + smooth) / (denom + smooth)
    return 1.0 - dice.mean()


def segmentation_loss(logits, probs, labels_onehot, xent_weight=1.0,
                      dice_weight=1.0, class_weights=None, group=None):
    """The hybrid supervised loss -> (loss, {"xent", "dice_loss"})."""
    xe = weighted_cross_entropy(logits, labels_onehot, class_weights, group)
    dl = soft_dice_loss(probs, labels_onehot, group=group)
    return xent_weight * xe + dice_weight * dl, {"xent": xe, "dice_loss": dl}


# -------------------------------------------------------------- adversarial
def _bce_logits(logits, target: float):
    """Binary cross-entropy with logits in the softplus form."""
    return torch.mean(torch.nn.functional.softplus(logits) - target * logits)


def d_loss_nonsat(src_logits, tgt_logits, label_smooth: float = 0.0):
    """Critic loss: source features classify as 1, target features as 0."""
    real = 1.0 - label_smooth
    return _bce_logits(src_logits.float(), real) + \
        _bce_logits(tgt_logits.float(), 0.0)


def g_loss_nonsat(tgt_logits):
    """Generator (DAM) loss: target features classify as source."""
    return _bce_logits(tgt_logits.float(), 1.0)


def d_loss_lsgan(src_logits, tgt_logits, label_smooth: float = 0.0):
    real = 1.0 - label_smooth
    return 0.5 * (torch.mean((src_logits.float() - real) ** 2)
                  + torch.mean(tgt_logits.float() ** 2))


def g_loss_lsgan(tgt_logits):
    return 0.5 * torch.mean((tgt_logits.float() - 1.0) ** 2)


def gan_losses(kind: str):
    """(d_loss_fn(src, tgt, smooth), g_loss_fn(tgt)) for a config string."""
    if kind == "nonsat":
        return d_loss_nonsat, g_loss_nonsat
    if kind == "lsgan":
        return d_loss_lsgan, g_loss_lsgan
    raise ValueError(f"unknown gan_loss {kind!r}")


def decision_boundary(kind: str) -> float:
    """The critic's decision boundary for ``critic_accuracy``: logit 0 for
    nonsat (probability 0.5); 0.5 for lsgan, the midpoint of the regression
    targets 1 (source) and 0 (target)."""
    if kind == "nonsat":
        return 0.0
    if kind == "lsgan":
        return 0.5
    raise ValueError(f"unknown gan_loss {kind!r}")


def critic_accuracy(src_logits, tgt_logits, boundary: float = 0.0):
    """Fraction of correct critic patch decisions; ~0.5 at the adversarial
    equilibrium.  ``boundary`` must match the loss (``decision_boundary``)."""
    correct = torch.mean((src_logits > boundary).float()) + \
        torch.mean((tgt_logits <= boundary).float())
    return 0.5 * correct
