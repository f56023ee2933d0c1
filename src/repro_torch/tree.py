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
    return leaves, _walk(tree, leaves, is_leaf)


def _walk(t, leaves: list, is_leaf):
    # a module-level function, not a closure over `leaves`: a recursive
    # closure refers to itself through its cell, and that cycle would keep
    # the leaves (tensors) alive until the cyclic collector runs
    if is_leaf is not None and is_leaf(t):
        leaves.append(t)
        return _LEAF
    if t is None:
        return ("none",)
    if isinstance(t, dict):
        return ("dict", tuple((k, _walk(t[k], leaves, is_leaf))
                              for k in sorted(t)))
    if _is_namedtuple(t):
        return ("namedtuple", type(t),
                tuple(_walk(v, leaves, is_leaf) for v in t))
    if isinstance(t, (list, tuple)):
        return (type(t).__name__,
                tuple(_walk(v, leaves, is_leaf) for v in t))
    leaves.append(t)
    return _LEAF


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
    _walk_up_to(spec, tree, out)
    return out


def _walk_up_to(s, t, out: list) -> None:
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
            _walk_up_to(c, t[k], out)
        return
    children = s[2] if kind == "namedtuple" else s[1]
    if not isinstance(t, (list, tuple)) or len(t) != len(children):
        raise ValueError("tree does not match the spec's sequence")
    for c, v in zip(children, t):
        _walk_up_to(c, v, out)


def leaves(tree, is_leaf=None) -> list:
    return flatten(tree, is_leaf)[0]


def flatten_with_path(tree, is_leaf=None) -> tuple:
    """([(path, leaf), ...], spec) in `flatten` order, as
    `jax.tree_util.tree_flatten_with_path` gives them: a path is a tuple
    of key strings, `['key']` for a dict key, `[i]` for a list or tuple
    index, `.field` for a NamedTuple field (`keystr` joins them)."""
    flat, spec = flatten(tree, is_leaf)
    paths: list = []
    _paths(spec, (), paths)
    return list(zip(paths, flat)), spec


def _paths(spec, prefix: tuple, out: list) -> None:
    if spec is _LEAF:
        out.append(prefix)
        return
    kind = spec[0]
    if kind == "none":
        return
    if kind == "dict":
        for k, c in spec[1]:
            _paths(c, prefix + (f"[{k!r}]",), out)
    elif kind == "namedtuple":
        for name, c in zip(spec[1]._fields, spec[2]):
            _paths(c, prefix + (f".{name}",), out)
    else:
        for i, c in enumerate(spec[1]):
            _paths(c, prefix + (f"[{i}]",), out)


def keystr(path: tuple) -> str:
    """`jax.tree_util.keystr` of a `flatten_with_path` path."""
    return "".join(path)


def map(fn, tree, *rest):  # noqa: A001 - mirrors jax.tree.map
    """Apply fn leafwise over trees of one structure (the others are read
    up to the first tree's leaves)."""
    flat, spec = flatten(tree)
    others = [flatten_up_to(spec, t) for t in rest]
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
