"""Device-side Dice (counterpart of ``mcmda_tpu/ops/metrics.py``); the
surface distances live in ``evaluation/metrics3d.py`` on the host."""

from __future__ import annotations

import torch


def dice_per_class(pred_labels, true_labels, num_classes: int):
    """Hard Dice per class from integer label maps of any shape -> [C] f32.
    A class absent from both prediction and truth scores 0.0, medpy's
    ``dc`` convention, as ``metrics3d.dice`` does."""
    classes = torch.arange(num_classes, device=pred_labels.device)
    p1 = (pred_labels.reshape(1, -1) == classes[:, None]).float()
    t1 = (true_labels.reshape(1, -1) == classes[:, None]).float()
    inter = (p1 * t1).sum(1)
    sizes = p1.sum(1) + t1.sum(1)
    return torch.where(sizes > 0, 2.0 * inter / torch.clamp_min(sizes, 1.0),
                       torch.zeros_like(sizes))


def mean_foreground_dice(pred_labels, true_labels, num_classes: int):
    return dice_per_class(pred_labels, true_labels, num_classes)[1:].mean()


def class_counts(labels, num_classes: int):
    """[C] int64 counts of each class in an integer label map of any shape;
    a label outside [0, C) (padding, -1) counts nowhere.  A one-hot sum:
    ``torch.bincount`` reads its input's maximum on the host, which a CUDA
    graph's capture refuses."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.reshape(-1, 1) == classes).sum(0)
