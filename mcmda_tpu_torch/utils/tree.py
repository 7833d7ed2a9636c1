"""Trees of tensors: the port's param / state trees (nested dicts) and the
training states that hold them (dataclasses, named tuples, tuples, lists
and dicts of tensors)."""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, *trees):
    """``fn`` applied leaf by leaf over dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _walk(node, visit):
    """A function that rebuilds ``node`` from an iterator of new leaves;
    ``visit`` sees each leaf (each tensor) in order.  Any other value that
    is not a container (None, a number) is a constant, kept as it is."""
    if isinstance(node, torch.Tensor):
        visit(node)
        return lambda it: next(it)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        subs = {f.name: _walk(getattr(node, f.name), visit)
                for f in dataclasses.fields(node)}
        return lambda it: dataclasses.replace(
            node, **{k: b(it) for k, b in subs.items()})
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        subs = [_walk(v, visit) for v in node]
        return lambda it: type(node)(*(b(it) for b in subs))
    if isinstance(node, (tuple, list)):
        subs = [_walk(v, visit) for v in node]
        return lambda it: type(node)(b(it) for b in subs)
    if isinstance(node, dict):
        subs = {k: _walk(v, visit) for k, v in node.items()}
        return lambda it: {k: b(it) for k, b in subs.items()}
    return lambda it: node


def leaves(tree) -> list:
    """The tensors of ``tree`` in order (dicts in key order)."""
    out: list = []
    _walk(tree, out.append)
    return out


def unflatten(like, values):
    """A tree of ``like``'s structure with ``values`` in place of its
    tensors, in the order ``leaves(like)`` gives them."""
    return _walk(like, lambda _: None)(iter(values))
