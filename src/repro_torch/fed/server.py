"""Server-side aggregation (port of `repro.fed.server`): decode
heterogeneous payloads, update the model.

Every payload is first decoded with its client's codec into a dense f32
delta tree, then aggregated:

  fedavg   x ← x + η_s · Σ w_i Δ̂_i                   (weighted delta mean)
  fedopt   a `repro_torch.optimizer` step on the pseudo-gradient
           g = −Σ w_i Δ̂_i
  fedmem   EF21-style per-client server memory: slot h_i is refreshed by
           every decoded Δ̂_i and the step uses the mean over ALL slots.

Two layouts share those semantics: `aggregate` takes one decoded tree per
participant and folds them left to right (the reference's list layout and
the oracle), `aggregate_stacked` takes every participant's delta as lane l
of one stacked tree. `ServerConfig.sum_mode` picks its lane reduction:

  "sequential"  materializes the weighted lanes (one broadcast multiply,
                the same rounding as the list layout's scalar multiplies),
                then folds pure adds left to right: bitwise the list
                layout;
  "pairwise"    balanced pairwise folding, O(log m) rounding depth: equal
                to the list layout only to float tolerance.

Weights are normalized by a tensor division (`w / sum(w)`), never by a
host float, and fedmem's two layouts run the same memory step, so they
cannot drift apart. fedmem's mean over the slots is a left-to-right fold
too (the reference's `jnp.mean`), so the card and the CPU agree on it. The m-independent tail (the η_s step, fedopt's
optimizer update) is the same code in both.

The stacked layout's reductions are the reference's jitted programs as
captured programs (`repro_torch.graph.Program`: a CUDA graph per
participant count on the card), registered with `repro_torch.obs.recompile`
under the reference's names ("fed.aggregate.mean", "fed.aggregate.memory"),
and each call is captured by an active obs session for the
"fed.round.aggregate" span. The weight checks and the normalization run
on the host before them; a program receives the normalized weights and
the participants' slot indices as tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import graph as graph_lib
from repro_torch import tree as tree_lib
from repro_torch.dist.sharding import fold, fold_mean
from repro_torch.obs import core as obs_lib
from repro_torch.obs import recompile as recompile_lib
from repro_torch.optimizer.optim import Optimizer, apply_updates

AGGREGATORS = ("fedavg", "fedopt", "fedmem")
SUM_MODES = ("sequential", "pairwise")


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    aggregator: str = "fedavg"
    server_lr: float = 1.0                  # fedavg / fedmem step size
    optimizer: Optional[Optimizer] = None   # required for fedopt
    sum_mode: str = "sequential"            # stacked-lane reduction order

    def __post_init__(self):
        if self.aggregator not in AGGREGATORS:
            raise ValueError(f"aggregator must be one of {AGGREGATORS}, "
                             f"got {self.aggregator!r}")
        if self.aggregator == "fedopt" and self.optimizer is None:
            raise ValueError("fedopt needs a repro_torch.optimizer Optimizer")
        if self.sum_mode not in SUM_MODES:
            raise ValueError(f"sum_mode must be one of {SUM_MODES}, "
                             f"got {self.sum_mode!r}")


class ServerState(NamedTuple):
    params: Any
    opt_state: Any    # fedopt only, else {}
    memory: Any       # fedmem: per-client slots stacked on axis 0, else {}


def init_server(params, cfg: ServerConfig, num_clients: int) -> ServerState:
    opt_state = (cfg.optimizer.init(params)
                 if cfg.aggregator == "fedopt" else {})
    memory = (tree_lib.map(
        lambda p: torch.zeros((num_clients,) + tuple(p.shape),
                              dtype=torch.float32, device=p.device),
        params) if cfg.aggregator == "fedmem" else {})
    return ServerState(params=params, opt_state=opt_state, memory=memory)


def decode_deltas(wires: Sequence, codecs: Sequence, metas: Sequence) -> list:
    """Per-client payloads → dense f32 delta trees."""
    return [codec.decode(wire, meta)
            for wire, codec, meta in zip(wires, codecs, metas)]


def tree_norm(tree) -> torch.Tensor:
    """Global ℓ2 norm of one tree (f32, leaves in flatten order)."""
    leaves = tree_lib.leaves(tree)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        sq = sq + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(sq)


def stacked_norms(tree) -> torch.Tensor:
    """Per-lane `tree_norm` of a stacked tree: (lanes,)."""
    leaves = tree_lib.leaves(tree)
    sq = torch.zeros(leaves[0].shape[0], dtype=torch.float32,
                     device=leaves[0].device)
    for x in leaves:
        sq = sq + torch.sum(torch.square(x.to(torch.float32)).reshape(
            x.shape[0], -1), dim=1)
    return torch.sqrt(sq)


def delta_norms(deltas: Sequence) -> list:
    """Host-side float64 per-tree ℓ2 norms (the high-precision oracle)."""
    def norm(tree) -> float:
        sq = 0.0
        for x in tree_lib.leaves(tree):
            flat = x.detach().cpu().to(torch.float64).reshape(-1)
            sq += float(flat @ flat)
        return math.sqrt(sq)

    return [norm(d) for d in deltas]


def _check_weights(weights, what: str = "weights") -> None:
    """Finite, non-negative weights with a positive sum (exact zeros are
    allowed: padding lanes carry weight 0)."""
    w = np.asarray(weights, np.float64)
    if w.size and (not np.all(np.isfinite(w)) or np.any(w < 0.0)):
        raise ValueError(
            f"{what} must be finite and non-negative with a positive sum "
            f"(exact zeros are allowed, e.g. padding lanes), got {w.tolist()}")
    total = float(np.sum(w))
    if not (total > 0.0 and math.isfinite(total)):
        raise ValueError(
            f"{what} must have a positive finite sum, got {total} — with "
            f'weighting="data_size" this usually means every participating '
            f"shard is empty")


def _normalized(weights, device) -> torch.Tensor:
    """w / Σw in f32, divided by a tensor."""
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                        device=device)
    return w / torch.sum(w)


def _device(tree) -> torch.device:
    return tree_lib.leaves(tree)[0].device


def weighted_mean(deltas: Sequence, weights) -> Any:
    """List-layout reference: Σ w_i Δ̂_i / Σ w_i, reduced left to right."""
    _check_weights(weights)
    w = _normalized(weights, _device(deltas[0]))
    acc = tree_lib.map(lambda x: w[0] * x.to(torch.float32), deltas[0])
    for i, d in enumerate(deltas[1:], start=1):
        acc = tree_lib.map(
            lambda a, x, i=i: a + w[i] * x.to(torch.float32), acc, d)
    return acc


def _apply_delta(params, direction, server_lr: float):
    """x ← x + η_s·direction, shared by both layouts."""
    return tree_lib.map(
        lambda p, d: (p.to(torch.float32) + server_lr * d).to(p.dtype),
        params, direction)


def _fedopt_tail(state: ServerState, cfg: ServerConfig, mean) -> ServerState:
    """Server-optimizer step from the weighted delta mean."""
    pseudo_grad = tree_lib.map(torch.negative, mean)
    updates, opt_state = cfg.optimizer.update(
        pseudo_grad, state.opt_state, state.params)
    return ServerState(apply_updates(state.params, updates),
                       opt_state, state.memory)


def _memory_inputs(memory, participant_ids, slot_weights) -> tuple:
    """The participants' slot indices (int64) and the normalized slot
    weights (None: the plain mean) as tensors on the memory's device, the
    weights checked first (host work before the program)."""
    dev = _device(memory)
    idx = torch.as_tensor(list(participant_ids), dtype=torch.int64,
                          device=dev)
    if slot_weights is None:
        return idx, None
    _check_weights(slot_weights, "slot_weights")
    return idx, _normalized(slot_weights, dev)


def _memory_step(memory, stacked, idx, sw):
    """fedmem: scatter the participants' deltas into their slots `idx`,
    then reduce ALL slots to the step direction, folded left to right (a
    library reduction sums in another order on the card than on the CPU,
    and fedmem's trajectory amplifies the last bit), weighted by the
    normalized slot weights `sw` (None: the mean). The same ops in both
    layouts."""
    def scatter(m, d):
        m = m.clone()
        m[idx] = d.to(torch.float32)
        return m

    memory = tree_lib.map(scatter, memory, stacked)
    if sw is None:
        direction = tree_lib.map(fold_mean, memory)
    else:
        direction = tree_lib.map(
            lambda m: fold(_lane_weights(sw, m) * m), memory)
    return memory, direction


def aggregate(state: ServerState, cfg: ServerConfig, deltas: Sequence,
              weights, participant_ids: Optional[Sequence[int]] = None,
              slot_weights=None) -> ServerState:
    """One server step from a LIST of decoded participant deltas (the
    reference layout). `participant_ids` (client indices aligned with
    `deltas`) tells fedmem which slots to refresh; `slot_weights` (one per
    client) weights fedmem's mean over the slots."""
    if not deltas:
        return state
    if cfg.aggregator == "fedavg":
        mean = weighted_mean(deltas, weights)
        return ServerState(_apply_delta(state.params, mean, cfg.server_lr),
                           state.opt_state, state.memory)
    if cfg.aggregator == "fedopt":
        return _fedopt_tail(state, cfg, weighted_mean(deltas, weights))
    if participant_ids is None:
        raise ValueError("fedmem aggregation needs participant_ids")
    stacked = tree_lib.map(
        lambda *xs: torch.stack([x.to(torch.float32) for x in xs]), *deltas)
    memory, direction = _memory_step(state.memory, stacked, *_memory_inputs(
        state.memory, participant_ids, slot_weights))
    return ServerState(_apply_delta(state.params, direction, cfg.server_lr),
                       state.opt_state, memory)


# ---------------------------------------------------------------------------
# Stacked-layout aggregation
# ---------------------------------------------------------------------------
def _lane_weights(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return w.reshape((-1,) + (1,) * (x.ndim - 1))


def _sequential_weighted_sum(stacked, w):
    """Σ w_l · lane_l folded LEFT TO RIGHT, bitwise `weighted_mean`'s loop:
    the weighted lanes are materialized first, then the fold is pure
    adds."""
    return tree_lib.map(
        lambda x: fold(_lane_weights(w, x) * x.to(torch.float32)), stacked)


def _pairwise_weighted_sum(stacked, w):
    """Σ w_l · lane_l by balanced pairwise folding (O(log m) depth): another
    summation order than the sequential reference."""
    def reduce_leaf(x):
        y = _lane_weights(w, x) * x.to(torch.float32)
        while y.shape[0] > 1:
            even = (y.shape[0] // 2) * 2
            folded = y[0:even:2] + y[1:even:2]
            if even != y.shape[0]:
                folded = torch.cat([folded, y[even:]], dim=0)
            y = folded
        return y[0]

    return tree_lib.map(reduce_leaf, stacked)


@functools.lru_cache(maxsize=None)
def _stacked_mean_fn(sum_mode: str):
    """`(stacked, w normalized) → Σ w_l · lane_l`, the fedavg/fedopt
    reduction of `sum_mode`, a captured program registered once per
    mode."""
    return recompile_lib.register(
        "fed.aggregate.mean", graph_lib.Program(
            _sequential_weighted_sum if sum_mode == "sequential"
            else _pairwise_weighted_sum), span="fed.round.aggregate")


@functools.lru_cache(maxsize=None)
def _stacked_memory_fn(has_slot_weights: bool):
    """fedmem's slot scatter and reduction over ALL slots, `(memory,
    stacked, idx, sw) → (memory, direction)`, a captured program
    registered once per slot weighting, as the reference compiles it."""
    return recompile_lib.register(
        "fed.aggregate.memory", graph_lib.Program(_memory_step),
        span="fed.round.aggregate")


def _stacked_mean(stacked, weights, sum_mode: str):
    _check_weights(weights)
    w = _normalized(weights, _device(stacked))
    mean_fn = _stacked_mean_fn(sum_mode)
    obs_lib.observe_program_call("fed.aggregate.mean", mean_fn, (stacked, w),
                                 span="fed.round.aggregate")
    return mean_fn(stacked, w)


def aggregate_stacked(state: ServerState, cfg: ServerConfig, stacked,
                      weights,
                      participant_ids: Optional[Sequence[int]] = None,
                      slot_weights=None) -> ServerState:
    """One server step from STACKED decoded deltas (lane l = participant l,
    in the order of `weights` / `participant_ids`). Semantics match
    `aggregate` on the unstacked lanes: bitwise under
    `sum_mode="sequential"`, to float tolerance under "pairwise"."""
    lanes = tree_lib.leaves(stacked)[0].shape[0]
    if lanes == 0:
        return state
    if np.asarray(weights).shape[0] != lanes:
        raise ValueError(f"{np.asarray(weights).shape[0]} weights for "
                         f"{lanes} stacked lanes")
    if cfg.aggregator == "fedavg":
        mean = _stacked_mean(stacked, weights, cfg.sum_mode)
        return ServerState(_apply_delta(state.params, mean, cfg.server_lr),
                           state.opt_state, state.memory)
    if cfg.aggregator == "fedopt":
        return _fedopt_tail(state, cfg,
                            _stacked_mean(stacked, weights, cfg.sum_mode))
    if participant_ids is None:
        raise ValueError("fedmem aggregation needs participant_ids")
    mem_fn = _stacked_memory_fn(slot_weights is not None)
    args = (state.memory, stacked) + _memory_inputs(
        state.memory, participant_ids, slot_weights)
    obs_lib.observe_program_call("fed.aggregate.memory", mem_fn, args,
                                 span="fed.round.aggregate")
    memory, direction = mem_fn(*args)
    return ServerState(_apply_delta(state.params, direction, cfg.server_lr),
                       state.opt_state, memory)
