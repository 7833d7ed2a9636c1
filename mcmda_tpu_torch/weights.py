"""Bridge between the JAX package's checkpoints and the port's trees.

The JAX package writes ``step_XXXXXXXX.npz`` checkpoints as a flat
``{keystr: array}`` dict (``mcmda_tpu/utils/checkpoint.py``, ``_flatten``),
keyed like ``.params['rm1']['b0']['bn1']['scale']`` for a ``SourceState``
and ``.src_params``, ``.src_bn``, ``.dam_params``, ``.tgt_bn`` and optionally
``.avg_dam``, ``.avg_bn``, ``.ema_w`` for an ``AdaptState``.  This module
turns such a file into the port's nested dicts of tensors on a device,
checking every tree against the shapes the config implies.

``flatten_state`` / ``unflatten_state`` carry a whole training state across
in both directions: the port's ``SourceState`` (a dataclass whose optimizer
state keeps optax's tuple-of-NamedTuples structure) flattens to exactly the
keys ``jax.tree_util.keystr`` gives the JAX state, e.g.
``.opt_state[0].mu['rm1']['b0']['conv1']['w']``, so each package restores
the other's npz checkpoints.

``read_checkpoint`` also reads the JAX package's orbax checkpoint
directories (``utils/orbax_read.py``, with ``tensorstore``); without
``tensorstore`` a directory raises, naming the one-line npz conversion.
"""

from __future__ import annotations

import dataclasses
import os
import re
import warnings

import numpy as np
import torch

from mcmda_tpu_torch.config import ExperimentConfig
from mcmda_tpu_torch.models import segmenter
from mcmda_tpu_torch.utils import orbax_read
from mcmda_tpu_torch.utils.tree import tree_map

_NAME = re.compile(r"\['([^'\]]*)'\]")


def read_checkpoint(path: str, like=None) -> dict:
    """The flat ``{keystr: array}`` dict of a checkpoint: an orbax
    directory (read by ``utils/orbax_read.py``; ``like``, a state, names
    its leaves and limits the read to them) or an npz file (``path`` may
    omit the ``.npz`` suffix, as the JAX package's step paths do)."""
    if os.path.isdir(path):
        return orbax_read.read(path, None if like is None else leaf_keys(like))
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


def _to_numpy(leaf):
    return (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf))


def _walk(node, key: str, out: dict, leaf=_to_numpy) -> None:
    """``leaf`` of each leaf of ``node`` under its ``jax.tree_util.keystr``
    name: dataclass fields and NamedTuple fields as ``.name``, tuple items
    as ``[i]``, dict items as ``['k']``; None holds no leaf."""
    if node is None:
        return
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            _walk(getattr(node, f.name), f"{key}.{f.name}", out, leaf)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for name in node._fields:
            _walk(getattr(node, name), f"{key}.{name}", out, leaf)
    elif isinstance(node, (tuple, list)):
        for i, child in enumerate(node):
            _walk(child, f"{key}[{i}]", out, leaf)
    elif isinstance(node, dict):
        for name, child in node.items():
            _walk(child, f"{key}['{name}']", out, leaf)
    else:
        out[key] = leaf(node)


def leaf_keys(state) -> list:
    """The keystr names of ``state``'s leaves, without reading them."""
    out: dict = {}
    _walk(state, "", out, leaf=lambda _: None)
    return list(out)


def flatten(tree: dict, field: str) -> dict:
    """Inverse of ``subtree``: ``{".<field>['a']['b']": array}``."""
    out: dict = {}
    _walk(tree, "." + field, out)
    return out


def flatten_state(state) -> dict:
    """A training state as the JAX package's flat npz dict
    (``mcmda_tpu/utils/checkpoint.py``, ``_flatten``)."""
    out: dict = {}
    _walk(state, "", out)
    return out


def unflatten_state(flat: dict, like, where: str = ""):
    """A state of ``like``'s structure with its leaves from the flat
    checkpoint dict ``flat``, each on its ``like`` leaf's device and dtype
    and checked against its shape.  A key the checkpoint lacks keeps the
    ``like`` value, with a warning, as the JAX package's restore does."""
    if like is None:
        return None
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: unflatten_state(flat, getattr(like, f.name),
                                    f"{where}.{f.name}")
            for f in dataclasses.fields(like)})
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(unflatten_state(flat, getattr(like, n),
                                            f"{where}.{n}")
                            for n in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(unflatten_state(flat, c, f"{where}[{i}]")
                          for i, c in enumerate(like))
    if isinstance(like, dict):
        return {k: unflatten_state(flat, v, f"{where}['{k}']")
                for k, v in like.items()}
    if where not in flat:
        warnings.warn(f"checkpoint lacks {where}; keeping the init value")
        return like
    arr = np.asarray(flat[where])
    if arr.shape != tuple(like.shape):
        raise ValueError(f"checkpoint {where}: shape {arr.shape} != "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)


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
    flat = read_checkpoint(path)
    params, state = segmenter.init(cfg.segmenter, device="meta")
    return (_field(flat, "params", params, device),
            _field(flat, "bn_state", state, device))


def restore_adapt(path: str, cfg: ExperimentConfig, device) -> dict:
    """The serving fields of an adaptation checkpoint: ``src_params``,
    ``src_bn``, ``dam_params``, ``tgt_bn``, and the weight-average trees
    ``avg_dam``, ``avg_bn``, ``ema_w`` (None when the run kept none)."""
    flat = read_checkpoint(path)
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

    return (tree_map(debias, state["avg_dam"], state["dam_params"]),
            tree_map(debias, state["avg_bn"], state["tgt_bn"]))
