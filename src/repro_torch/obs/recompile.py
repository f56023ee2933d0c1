"""Recompile tracker: cache sizes of named programs (port of
`repro.obs.recompile`).

A program that compiles specializations exposes `_cache_size()`, the number
of distinct (shape/dtype/static-arg) specializations it holds. Every program
factory of the port's hot layers registers its program here under the
reference's name ("fed.round.cohort", "dist.step", "serve.decode_step", …);
`counts()` sums live cache sizes per name, so a snapshot/delta pair
attributes new specializations to whatever ran in between.

The port's programs run eagerly and have no `_cache_size`: `cache_size`
gives None for them, as the reference's does for a callable without cache
introspection, and they count 0. A program that captures graphs (a CUDA
graph per shape) gives itself a `_cache_size()`, and its count appears
here with no change to this module.

Registration is always on (one dict insert per factory call, never on
the step path) and holds only weakrefs. An active `repro_torch.obs`
session pins the programs registered while it is enabled (via
`add_callback`) so their last cache sizes survive into the session summary
even if their owner is dropped first; `counts()` also remembers the last
size of every entry.
"""
from __future__ import annotations

import itertools
import weakref
from typing import Callable, Optional

_REGISTRY: dict[int, dict] = {}   # id -> {name, ref, last, annotations}
_IDS = itertools.count()
_CALLBACKS: list[Callable] = []   # called as cb(name, fn) on every register


def cache_size(fn) -> Optional[int]:
    """Specialization count of a program that exposes `_cache_size()`, or
    None when it has no cache introspection (an eager callable)."""
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:
        return None


def register(name: str, fn, **annotations):
    """Track `fn`'s compilation cache under `name`. Returns `fn` (so call
    sites can wrap: `return register("x", make_program(...))`).

    Keyword `annotations` attach static facts the cost model reads per
    program — e.g. `span="fed.round.aggregate"` (which measured span this
    program's device work should be attributed to) or
    `wire_bytes_per_call=...` (the analytic minimum-traffic bytes one call
    puts on the wire). Re-registering a name merges annotations
    (`annotations_by_name` folds entries left-to-right)."""
    try:
        ref = weakref.ref(fn)
    except TypeError:                     # non-weakrefable: hold it
        ref = (lambda fn=fn: fn)
    _REGISTRY[next(_IDS)] = {"name": name, "ref": ref, "last": 0,
                             "annotations": dict(annotations)}
    for cb in list(_CALLBACKS):
        cb(name, fn)
    return fn


def annotations_by_name() -> dict:
    """{program name: merged annotation dict} over all registrations."""
    out: dict[str, dict] = {}
    for entry in _REGISTRY.values():
        ann = entry.get("annotations")
        if ann:
            out.setdefault(entry["name"], {}).update(ann)
    return out


def add_callback(cb: Callable) -> None:
    _CALLBACKS.append(cb)


def remove_callback(cb: Callable) -> None:
    if cb in _CALLBACKS:
        _CALLBACKS.remove(cb)


def counts() -> dict:
    """{program name: total specializations} over all registered
    programs. Live programs report their current `_cache_size()`; dead ones
    report the last size observed before they were collected."""
    out: dict[str, int] = {}
    for entry in _REGISTRY.values():
        fn = entry["ref"]()
        if fn is not None:
            size = cache_size(fn)
            if size is not None:
                entry["last"] = size
        out[entry["name"]] = out.get(entry["name"], 0) + entry["last"]
    return out


def delta(before: dict, after: dict) -> dict:
    """Per-name specializations in `after` not yet present in `before`
    (clamped at 0 — a program collected between snapshots can't lose
    them)."""
    out = {}
    for name, n in after.items():
        d = n - before.get(name, 0)
        if d > 0:
            out[name] = d
    return out


def clear() -> None:
    """Drop every registration (test isolation only)."""
    _REGISTRY.clear()
