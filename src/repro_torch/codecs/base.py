"""The `TreeCodec` convention (port of `repro.codecs.base`): the one call
surface every codec implements.

    wire  = codec.encode(key, tree, round_idx)        # payload tree
    meta  = codec.meta(tree)                          # static, host-side
    tree' = codec.decode(wire, meta)
    bits  = codec.wire_bits(tree)                     # analytic audit
    bytes = codec.wire_bytes(wire, meta)              # realized ledger entry

A key is a `repro_torch.random` key, an int64 tensor (2,). The fed engine
runs a cohort of L clients as lanes: trees whose leaves carry a leading
lane axis, one key per lane (L, 2). `encode_lanes`, `encode_ef_lanes` and
`decode_lanes` below run a codec over lanes; a codec that has a lane path
(the chunked ndsc and ratq leaves: one kernel launch per leaf over every
lane's chunks) sets the matching field, and any other codec runs lane by
lane. Either way lane l is bitwise the codec's call on lane l alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch import tree as tree_lib


class TreeMeta:
    """Static decode-side metadata for one tree template."""

    def __init__(self, treedef, infos, extra=None):
        self.treedef = treedef
        self.infos = infos            # [(size, shape, dtype), ...]
        self.extra = extra            # backend-specific (e.g. per-leaf stages)


@dataclasses.dataclass(frozen=True)
class TreeCodec:
    """The unified `(key, tree, budget) -> (payload, bits)` convention."""

    name: str
    encode: Callable      # (key, tree, round_idx=0) -> wire tree
    decode: Callable      # (wire, meta) -> tree
    meta: Callable        # (tree template) -> TreeMeta (host-side, static)
    wire_bits: Callable   # (tree template) -> float — analytic audit
    wire_bytes: Callable  # (wire, meta) -> float — realized ledger entry
    rate: Optional[float] = None   # effective bits/dim when well-defined
    sim_only: bool = False         # True: `wire` is the decoded tree itself
    spec: Optional[tuple] = None   # hashable identity: equal specs ⇒ the
                                   # codecs are interchangeable (same factory,
                                   # budget and kwargs) — the cohort-key unit
    encode_ef: Optional[Callable] = None
    # (key, tree, meta, round_idx=0) -> (wire, residual tree): the fused
    # encode + error-feedback residual u − D(E(u)), same wire as `encode`
    encode_lanes: Optional[Callable] = None
    # (keys (L, 2), lane tree, round_idx=0) -> lane wire
    encode_ef_lanes: Optional[Callable] = None
    # (keys, lane tree, meta, round_idx=0) -> (lane wire, lane residual)
    decode_lanes: Optional[Callable] = None
    # (lane wire, meta) -> lane tree

    def compress(self, key, tree, round_idx=0):
        """One-shot (payload, analytic bits)."""
        return self.encode(key, tree, round_idx), self.wire_bits(tree)


def leaf_size(x) -> int:
    """Values in a leaf (1 for a scalar)."""
    return math.prod(x.shape) if len(x.shape) else 1


def tree_meta(tree) -> tuple:
    """(spec, [(size, shape, dtype), ...]) of a tree template."""
    leaves, spec = tree_lib.flatten(tree)
    return spec, [(leaf_size(x), tuple(x.shape), x.dtype) for x in leaves]


def total_dims(tree) -> int:
    return sum(leaf_size(x) for x in tree_lib.leaves(tree))


def stack(trees: list):
    """Trees of one structure stacked along a new leading lane axis."""
    return tree_lib.map(lambda *xs: torch.stack(xs), *trees)


def lane(tree, i: int):
    """Lane i of a lane tree (views)."""
    return tree_lib.map(lambda a: a[i], tree)


def encode_lanes(codec: TreeCodec, keys: torch.Tensor, tree,
                 round_idx: int = 0):
    """codec.encode of each lane of `tree` under keys[l], as one lane wire."""
    if codec.encode_lanes is not None:
        return codec.encode_lanes(keys, tree, round_idx)
    return stack([codec.encode(keys[i], lane(tree, i), round_idx)
                  for i in range(keys.shape[0])])


def encode_ef_lanes(codec: TreeCodec, keys: torch.Tensor, tree, meta,
                    round_idx: int = 0) -> tuple:
    """codec.encode_ef over lanes: (lane wire, lane residual)."""
    if codec.encode_ef_lanes is not None:
        return codec.encode_ef_lanes(keys, tree, meta, round_idx)
    pairs = [codec.encode_ef(keys[i], lane(tree, i), meta, round_idx)
             for i in range(keys.shape[0])]
    return stack([w for w, _ in pairs]), stack([r for _, r in pairs])


def decode_lanes(codec: TreeCodec, wire, meta, lanes: int):
    """codec.decode of each lane of a lane wire, as one lane tree."""
    if codec.decode_lanes is not None:
        return codec.decode_lanes(wire, meta)
    return stack([codec.decode(lane(wire, i), meta) for i in range(lanes)])
