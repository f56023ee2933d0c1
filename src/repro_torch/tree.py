"""Nested-dict trees of tensors, flattened in `jax.tree` order.

`jax.tree.flatten` visits dict keys in sorted order, and the codec keys each
leaf's frame signs by its position in that order. So the port flattens
parameter, gradient, optimizer, EF and client-state trees the same way:
dicts by sorted key, lists, tuples and NamedTuples in order (a NamedTuple
comes back as its own type), `None` as an empty subtree, anything else a
leaf. A spec is a nested tuple, hashable and comparable like a treedef.
"""
from __future__ import annotations

_LEAF = None


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(type(t), "_fields")


def flatten(tree, is_leaf=None) -> tuple:
    """Returns (leaves, spec); `unflatten(spec, leaves)` rebuilds the tree."""
    leaves: list = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return _LEAF
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            return ("dict", tuple((k, walk(t[k])) for k in sorted(t)))
        if _is_namedtuple(t):
            return ("namedtuple", type(t), tuple(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, tuple(walk(v) for v in t))
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def _build(spec, take):
    """The tree of `spec` with each leaf position filled by take()."""
    if spec is _LEAF:
        return take()
    kind = spec[0]
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, take) for k, c in spec[1]}
    if kind == "namedtuple":
        return spec[1](*[_build(c, take) for c in spec[2]])
    seq = [_build(c, take) for c in spec[1]]
    return tuple(seq) if kind == "tuple" else seq


def unflatten(spec, leaves) -> object:
    it = iter(leaves)
    out = _build(spec, lambda: next(it))
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree spec holds")
    return out


def flatten_up_to(spec, tree) -> list:
    """The subtrees of `tree` at the leaf positions of `spec` (jax's
    `treedef.flatten_up_to`): `tree` must have spec's structure down to
    those positions, and whatever sits there (a payload dict, say) comes
    back whole."""
    out: list = []

    def walk(s, t):
        if s is _LEAF:
            out.append(t)
            return
        kind = s[0]
        if kind == "none":
            if t is not None:
                raise ValueError(f"expected None, got {type(t).__name__}")
            return
        if kind == "dict":
            if not isinstance(t, dict) or sorted(t) != [k for k, _ in s[1]]:
                raise ValueError("tree does not match the spec's dict keys")
            for k, c in s[1]:
                walk(c, t[k])
            return
        children = s[2] if kind == "namedtuple" else s[1]
        if not isinstance(t, (list, tuple)) or len(t) != len(children):
            raise ValueError("tree does not match the spec's sequence")
        for c, v in zip(children, t):
            walk(c, v)

    walk(spec, tree)
    return out


def leaves(tree, is_leaf=None) -> list:
    return flatten(tree, is_leaf)[0]


def map(fn, tree, *rest):  # noqa: A001 - mirrors jax.tree.map
    """Apply fn leafwise over trees of one structure (the others are read
    up to the first tree's leaves)."""
    flat, spec = flatten(tree)
    others = [flatten_up_to(spec, t) for t in rest]
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
