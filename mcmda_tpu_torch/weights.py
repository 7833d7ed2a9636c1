"""Bridge from the JAX package's checkpoints to the port's param trees.

The JAX package writes ``step_XXXXXXXX.npz`` checkpoints as a flat
``{keystr: array}`` dict (``mcmda_tpu/utils/checkpoint.py``, ``_flatten``),
keyed like ``.params['rm1']['b0']['bn1']['scale']`` for a ``SourceState``
and ``.src_params``, ``.src_bn``, ``.dam_params``, ``.tgt_bn`` and optionally
``.avg_dam``, ``.avg_bn``, ``.ema_w`` for an ``AdaptState``.  This module
turns such a file into the port's nested dicts of tensors on a device,
checking every tree against the shapes the config implies.

Orbax checkpoint directories cannot be read without ``jax`` and raise.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from mcmda_tpu_torch.config import ExperimentConfig
from mcmda_tpu_torch.models import segmenter

_NAME = re.compile(r"\['([^'\]]*)'\]")


def read_npz(path: str) -> dict:
    """The flat ``{keystr: array}`` dict of an npz checkpoint; ``path`` may
    omit the ``.npz`` suffix, as the JAX package's step paths do."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory, which cannot be read "
            "without jax.  Re-save it as npz from the JAX package: "
            "numpy.savez(path + '.npz', "
            "**mcmda_tpu.utils.checkpoint._flatten(state))")
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as z:
        return {k: z[k] for k in z.files}


def subtree(flat: dict, field: str) -> dict | None:
    """The nested dict under ``.<field>`` of a flat checkpoint dict (None
    when the checkpoint has no such field)."""
    prefix = "." + field
    tree: dict = {}
    found = False
    for key, value in flat.items():
        if not key.startswith(prefix + "["):
            continue
        names = _NAME.findall(key[len(prefix):])
        if prefix + "".join(f"['{n}']" for n in names) != key:
            raise ValueError(f"unrecognised checkpoint key {key!r}")
        node = tree
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = value
        found = True
    return tree if found else None


def flatten(tree: dict, field: str) -> dict:
    """Inverse of ``subtree``: ``{".<field>['a']['b']": array}``."""
    out = {}

    def walk(node, key):
        if isinstance(node, dict):
            for name, child in node.items():
                walk(child, f"{key}['{name}']")
        else:
            out[key] = (node.detach().cpu().numpy()
                        if isinstance(node, torch.Tensor)
                        else np.asarray(node))

    walk(tree, "." + field)
    return out


def _to_device(tree, like, where: str, device):
    """Tensors of ``tree`` on ``device``, after checking its keys and shapes
    against ``like``."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"checkpoint {where}: keys {got} != "
                             f"{sorted(like)}")
        return {k: _to_device(tree[k], like[k], f"{where}['{k}']", device)
                for k in like}
    arr = np.asarray(tree, np.float32)
    if arr.shape != tuple(like.shape):
        raise ValueError(f"checkpoint {where}: shape {arr.shape} != "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(arr).to(device)


def _field(flat, field, like, device):
    tree = subtree(flat, field)
    if tree is None:
        raise ValueError(f"checkpoint has no .{field} tree")
    return _to_device(tree, like, "." + field, device)


def restore_source(path: str, cfg: ExperimentConfig, device):
    """(params, bn_state) of a source-training checkpoint."""
    flat = read_npz(path)
    params, state = segmenter.init(cfg.segmenter, device="meta")
    return (_field(flat, "params", params, device),
            _field(flat, "bn_state", state, device))


def restore_adapt(path: str, cfg: ExperimentConfig, device) -> dict:
    """The serving fields of an adaptation checkpoint: ``src_params``,
    ``src_bn``, ``dam_params``, ``tgt_bn``, and the weight-average trees
    ``avg_dam``, ``avg_bn``, ``ema_w`` (None when the run kept none)."""
    flat = read_npz(path)
    params, state = segmenter.init(cfg.segmenter, device="meta")
    dam, _ = segmenter.dam_split(params, cfg.segmenter, cfg.adapt.plug_depth)
    out = {"src_params": _field(flat, "src_params", params, device),
           "src_bn": _field(flat, "src_bn", state, device),
           "dam_params": _field(flat, "dam_params", dam, device),
           "tgt_bn": _field(flat, "tgt_bn", state, device),
           "avg_dam": None, "avg_bn": None, "ema_w": None}
    if ".ema_w" in flat:
        out["avg_dam"] = _field(flat, "avg_dam", dam, device)
        out["avg_bn"] = _field(flat, "avg_bn", state, device)
        out["ema_w"] = torch.tensor(float(flat[".ema_w"]), device=device)
    return out


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def eval_weights(state: dict, use_avg: bool = False):
    """(dam_params, bn) to serve with: the live DAM and target BN, or the
    bias-corrected weight average ``avg / ema_w``.  Falls back to the live
    weights while nothing was folded in (``ema_w == 0``) and when the run
    kept no average (``adapt.eval_weights`` of the JAX package)."""
    if not use_avg or state["ema_w"] is None:
        return state["dam_params"], state["tgt_bn"]
    w = state["ema_w"]
    nz = (w > 0).float()
    inv = nz / torch.clamp_min(w, 1e-12)

    def debias(avg, live):
        return avg * inv + (1 - nz) * live

    return (_tree_map(debias, state["avg_dam"], state["dam_params"]),
            _tree_map(debias, state["avg_bn"], state["tgt_bn"]))
