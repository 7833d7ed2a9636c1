"""Supervised segmentation losses (counterpart of the segmentation part of
``mcmda_tpu/ops/losses.py``): weighted cross-entropy + multi-class soft
Dice.  All reduce to f32 scalars over the whole batch.  The adversarial
losses come with adaptation."""

from __future__ import annotations

import torch


def weighted_cross_entropy(logits, labels_onehot, class_weights=None):
    """Per-pixel softmax cross-entropy, optionally class-weighted.

    ``class_weights=None`` uses inverse-frequency weights computed from the
    batch -- background pixels dominate cardiac slices ~20:1."""
    logp = torch.log_softmax(logits, dim=-1)
    if class_weights is None:
        freq = labels_onehot.mean((0, 1, 2))  # [C]
        class_weights = 1.0 / (freq + 1e-3)
        class_weights = class_weights / class_weights.sum()
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=logits.device)
    pix_w = (labels_onehot * w).sum(-1)  # [N,H,W]
    xent = -(labels_onehot * logp).sum(-1)
    return (pix_w * xent).sum() / (pix_w.sum() + 1e-8)


def soft_dice_loss(probs, labels_onehot, smooth: float = 1.0,
                   skip_background: bool = True):
    """Multi-class soft Dice loss over the batch: Dice per class over all
    pixels, averaged over the (foreground) classes; loss = 1 - mean Dice."""
    start = 1 if skip_background else 0
    p = probs[..., start:].float()
    t = labels_onehot[..., start:].float()
    inter = (p * t).sum((0, 1, 2))
    denom = p.sum((0, 1, 2)) + t.sum((0, 1, 2))
    dice = (2.0 * inter + smooth) / (denom + smooth)
    return 1.0 - dice.mean()


def segmentation_loss(logits, probs, labels_onehot, xent_weight=1.0,
                      dice_weight=1.0, class_weights=None):
    """The hybrid supervised loss -> (loss, {"xent", "dice_loss"})."""
    xe = weighted_cross_entropy(logits, labels_onehot, class_weights)
    dl = soft_dice_loss(probs, labels_onehot)
    return xent_weight * xe + dice_weight * dl, {"xent": xe, "dice_loss": dl}
