"""Nested dicts, lists and tuples of tensors (the port's parameter and
batch "pytrees"): flatten to a list of leaves and rebuild."""

from __future__ import annotations

from typing import Callable


def flatten(tree) -> tuple[list, Callable[[list], object]]:
    """-> (leaves in a fixed order, rebuild(new_leaves) -> same
    structure)."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = list(node)
            subs = [walk(node[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(node, (list, tuple)):
            subs = [walk(x) for x in node]
            kind = type(node)
            return lambda it: kind(s(it) for s in subs)
        leaves.append(node)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def tree_map(fn, tree):
    leaves, rebuild = flatten(tree)
    return rebuild([fn(x) for x in leaves])
