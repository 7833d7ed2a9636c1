"""Reader of the JAX package's orbax checkpoint directories, on
``tensorstore`` alone (imported when a directory is read, never at import).

On one device the JAX package saves a state with orbax's
``StandardCheckpointHandler`` (``mcmda_tpu/utils/checkpoint.py``, ``save``):
``step_XXXXXXXX/`` holds ``_METADATA`` (JSON) and an OCDBT key-value
database in which each leaf is a zarr (v2) array under its dotted path,
e.g. ``params.rm1.b0.conv1.w/``.  ``_METADATA``'s ``tree_metadata`` names
each leaf as a tuple of keys, each with a ``key_type``: 1 for a sequence
index, 2 for a dict key, a dataclass field and a NamedTuple field alike.
So the directory cannot tell ``.mu`` from ``['mu']``, and a leaf is matched
to its ``jax.tree_util.keystr`` name through the name tuples of a ``like``
state's leaves.  Without one, the first key is taken as a field and the
rest by key type, which names every leaf of a dict subtree right
(``.params['rm1']['b0']['conv1']['w']``).

``read`` returns the flat ``{keystr: np.ndarray}`` dict that
``weights.read_checkpoint`` returns for an npz file.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

_SEQUENCE, _MAPPING = 1, 2
_TOKEN = re.compile(r"\.([^.\[]+)|\[(\d+)\]|\['([^'\]]*)'\]")


def _unreadable(path: str, why: str) -> ValueError:
    return ValueError(
        f"{path} is an orbax checkpoint directory, which cannot be read "
        f"{why}.  Re-save it as npz from the JAX package: "
        "numpy.savez(path + '.npz', "
        "**mcmda_tpu.utils.checkpoint._flatten(state))")


def _tensorstore(path: str):
    try:
        import tensorstore
    except ImportError:
        raise _unreadable(path, "without tensorstore (not installed)") \
            from None
    return tensorstore


def require(path: str) -> None:
    """Raise the reader's error if ``path`` could not be read here
    (``tensorstore`` missing)."""
    _tensorstore(path)


def names_of(keystr: str) -> tuple:
    """The orbax name tuple of a ``keystr`` leaf name:
    ``.opt_state[0].mu['w']`` -> ``('opt_state', '0', 'mu', 'w')``."""
    names = tuple(a or b or c for a, b, c in _TOKEN.findall(keystr))
    if keystr and not names:
        raise ValueError(f"unrecognised leaf name {keystr!r}")
    return names


def _keystr(key_metadata) -> str:
    """A leaf's keystr without a ``like`` state: the first key a field,
    the rest an index (key type 1) or a dict key."""
    parts = []
    for i, k in enumerate(key_metadata):
        name = str(k["key"])
        if i == 0:
            parts.append(f".{name}")
        elif k.get("key_type") == _SEQUENCE:
            parts.append(f"[{name}]")
        else:
            parts.append(f"['{name}']")
    return "".join(parts)


def read(path: str, like_keys=None) -> dict:
    """The flat ``{keystr: np.ndarray}`` dict of the orbax checkpoint
    directory ``path``.  ``like_keys``, the keystr names of a state's
    leaves, names the leaves and limits the read to them; a leaf of the
    directory outside it is not read."""
    ts = _tensorstore(path)
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_path):
        raise _unreadable(path, "here: it has no _METADATA (an unfinished "
                          "or foreign save)")
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise _unreadable(path, "here: only the OCDBT + zarr v2 layout of "
                          "orbax's default save is supported")
    lookup = None if like_keys is None else \
        {names_of(k): k for k in like_keys}
    base = "file://" + os.path.abspath(path)
    context = ts.Context()
    pending = []
    for leaf in meta["tree_metadata"].values():
        if leaf.get("value_metadata", {}).get("skip_deserialize"):
            continue  # None / empty optimizer states hold no array
        keys = leaf["key_metadata"]
        names = tuple(str(k["key"]) for k in keys)
        if lookup is None:
            key = _keystr(keys)
        elif names in lookup:
            key = lookup[names]
        else:
            continue
        spec = {"driver": "zarr",
                "kvstore": {"driver": "ocdbt", "base": base,
                            "path": ".".join(names) + "/"}}
        pending.append((key, ts.open(spec, open=True, context=context)))
    reads = [(key, fut.result().read()) for key, fut in pending]
    return {key: np.asarray(fut.result()) for key, fut in reads}
