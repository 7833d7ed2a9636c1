"""Nested dicts of tensors (the port's param / state trees)."""

from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` applied leaf by leaf over dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> list:
    """The leaves in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    return [tree]


def unflatten(like, values) -> dict:
    """A tree of ``like``'s structure with ``values`` as its leaves, in the
    order ``leaves(like)`` gives them."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)

    return build(like)
