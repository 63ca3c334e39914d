"""Nested dicts, lists and tuples of tensors (the port's parameter and
batch "pytrees"): flatten to a list of leaves and rebuild, and name each
leaf by its path."""

from __future__ import annotations

from typing import Callable


def flatten(tree) -> tuple[list, Callable[[list], object]]:
    """-> (leaves in a fixed order, rebuild(new_leaves) -> same
    structure)."""
    leaves: list = []
    build = _builder(tree, leaves)
    return leaves, lambda new: build(iter(new))


def _builder(node, leaves: list):
    """Append ``node``'s leaves to ``leaves``; -> build(it), the same
    structure from an iterator of leaves.  A module function, not a
    closure that calls itself: such a closure is a reference cycle, and
    the leaves it holds (a training step's old parameters) would wait
    for the garbage collector instead of going with the last reference."""
    if isinstance(node, dict):
        keys = list(node)
        subs = [_builder(node[k], leaves) for k in keys]
        return lambda it: {k: s(it) for k, s in zip(keys, subs)}
    if isinstance(node, (list, tuple)):
        subs = [_builder(x, leaves) for x in node]
        kind = type(node)
        return lambda it: kind(s(it) for s in subs)
    leaves.append(node)
    return lambda it: next(it)


def tree_map(fn, tree):
    leaves, rebuild = flatten(tree)
    return rebuild([fn(x) for x in leaves])


def leaf_paths(tree) -> list[str]:
    """Each leaf's key, in `flatten`'s order: the ``/``-joined dict keys
    and list / tuple indices on the way to it, as the JAX package's
    `utils/checkpoint.py` names a leaf of `tree_flatten_with_path`
    ("layers/0/wq", "layers/3/wo/1" for the B of a LoRA pair)."""
    paths: list[str] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, path + (str(i),))
        else:
            paths.append("/".join(path))

    walk(tree, ())
    return paths
