"""Nested-dict trees of tensors, flattened in `jax.tree` order.

`jax.tree.flatten` visits dict keys in sorted order, and the codec keys each
leaf's frame signs by its position in that order. So the port flattens
parameter, gradient, optimizer and EF trees the same way: dicts by sorted
key, lists and tuples in order, anything else a leaf.
"""
from __future__ import annotations


def flatten(tree, is_leaf=None) -> tuple:
    """Returns (leaves, spec); `unflatten(spec, leaves)` rebuilds the tree."""
    leaves: list = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return None
        if isinstance(t, dict):
            return ("dict", tuple((k, walk(t[k])) for k in sorted(t)))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, tuple(walk(v) for v in t))
        leaves.append(t)
        return None

    return leaves, walk(tree)


def unflatten(spec, leaves) -> object:
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, children = s
        if kind == "dict":
            return {k: build(c) for k, c in children}
        seq = [build(c) for c in children]
        return tuple(seq) if kind == "tuple" else seq

    out = build(spec)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree spec holds")
    return out


def leaves(tree, is_leaf=None) -> list:
    return flatten(tree, is_leaf)[0]


def map(fn, tree, *rest):  # noqa: A001 - mirrors jax.tree.map
    """Apply fn leafwise over trees of one structure."""
    flat, spec = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
