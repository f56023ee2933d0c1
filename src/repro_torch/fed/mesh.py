"""The mesh federation backend: cohort lanes split over the ranks (port of
`repro.fed.mesh`).

The reference shards a cohort's stacked lane trees over the mesh's data
axes and runs each device's lanes inside one `shard_map` program. In the
port every rank runs the same `Federation` (the same clients, data and
seed), and a cohort's lanes are split over the ranks of a
`torch.distributed` group (`repro_torch.dist.sharding`):

  * a cohort of n lanes is padded to `padded_lanes(n, m)` by repeating
    lane 0 (`clients.stack_padded`), and rank r runs the cohort round and
    its decode on lanes [r·L/m, (r+1)·L/m) of the L padded lanes. Real
    lanes keep positions 0..n−1; padded lanes carry weight 0. A lane's
    arithmetic is the vmap backend's (lanes are independent), so wires,
    EF states, decoded deltas and norms agree bit for bit.

Server reduce (`ServerConfig.sum_mode`):

  "sequential"  every rank all-gathers the decoded lanes in rank order,
                cuts off the padding and replays
                `server._sequential_weighted_sum`: one collective per
                leaf, then the single-process fold's float ops, so params,
                optimizer state and EF are bitwise the vmap backend's.
  "pairwise"    each rank folds its own weighted lanes pairwise and the
                partial sums meet in an `all_reduce`: equal to the
                reference only to float tolerance (padding lanes are
                killed by their zero weights first).

fedmem reduces over ALL memory slots, not over the lanes, so the mesh
backend gathers the decoded stack and reuses `server.aggregate_stacked`.

The lane fold is one program per (group, sum mode, lane count), registered
with `repro_torch.obs.recompile` as "fed.aggregate.mesh", as in the
reference; the cohort round registers as "fed.round.mesh" where
`Federation` builds it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.codecs import base as codec_base
from repro_torch.dist.sharding import (all_gather_stack, all_reduce_sum,
                                       num_workers, padded_lanes,
                                       worker_index)
from repro_torch.fed import clients as clients_lib
from repro_torch.fed import server as server_lib
from repro_torch.obs import recompile as recompile_lib


@dataclasses.dataclass(frozen=True)
class LaneShard:
    """This rank's block of a lane stack padded to `total` lanes (the
    round program's own output, fed to the fold without a reshard)."""

    local: object
    total: int


def default_mesh():
    """The group a `Federation(backend="mesh")` takes when none is given:
    the default (world) group, or None (one rank) when torch.distributed
    is not initialized."""
    return dist.group.WORLD if dist.is_initialized() else None


def lane_axis_size(group) -> int:
    """Ranks the lane axis splits over (≥ 1)."""
    return max(num_workers(group), 1)


def _block(total: int, group) -> slice:
    """This rank's lanes of `total` padded lanes."""
    k = total // lane_axis_size(group)
    r = worker_index(group)
    return slice(r * k, (r + 1) * k)


def gather_lanes(tree, total: int, group):
    """A lane tree split over the ranks ((total/m, …) here) → the whole
    (total, …) tree on every rank, lanes in global order."""
    if group is None:
        return tree
    return tree_lib.map(
        lambda x: all_gather_stack(x, group).reshape(
            (total,) + tuple(x.shape[1:])), tree)


# ---------------------------------------------------------------------------
# Client side: one cohort round, lanes split over the ranks
# ---------------------------------------------------------------------------
def make_mesh_cohort_round(loss_fn, codec, client_cfg, params_template,
                           group):
    """(params, stacked data, stacked states, round_idx) → (wires, states,
    decoded deltas, per-lane norms) of THIS rank's lanes.

    The stacked data and states carry every padded lane (a multiple of the
    group's size); the results carry the rank's block of them. The rank
    runs `clients.make_cohort_round` and decodes its lanes' payloads
    (`codecs.base.decode_lanes`): encode → decode runs where the lane
    lives, and nothing lane-sized crosses ranks before the reduce."""
    meta = codec.meta(params_template)
    body = clients_lib.make_cohort_round(loss_fn, codec, client_cfg,
                                         params_template)

    def local_lanes(params, data, state, round_idx):
        own = _block(state.key.shape[0], group)
        data = tree_lib.map(lambda x: x[own], data)
        state = tree_lib.map(lambda x: x[own], state)
        wires, new_state = body(params, data, state, round_idx)
        decoded = codec_base.decode_lanes(codec, wires, meta,
                                          state.key.shape[0])
        return wires, new_state, decoded, server_lib.stacked_norms(decoded)

    return local_lanes


# ---------------------------------------------------------------------------
# Server side: the lane fold as a collective
# ---------------------------------------------------------------------------
def _place_lanes(tree, group) -> tuple:
    """(this rank's block, total lanes) of a lane stack. A `LaneShard`
    (the round program's output, padding included) passes through; a
    whole stack is padded with zero lanes to `padded_lanes` and cut.
    "sequential" never reads padding lanes and "pairwise" weights them 0."""
    if isinstance(tree, LaneShard):
        return tree.local, tree.total
    lanes = tree_lib.leaves(tree)[0].shape[0]
    total = padded_lanes(lanes, lane_axis_size(group))
    own = _block(total, group)

    def cut(x):
        if total != lanes:
            x = torch.cat([x, x.new_zeros((total - lanes,)
                                          + tuple(x.shape[1:]))])
        return x[own]

    return tree_lib.map(cut, tree), total


def mesh_weighted_mean(stacked, weights, group, sum_mode: str = "sequential",
                       lanes: Optional[int] = None):
    """Σ (w/Σw)_l · lane_l over the first `lanes` lanes, reduced across the
    ranks. `stacked` is a whole lane stack (every rank holds it) or a
    `LaneShard`; `lanes` is the REAL lane count (default: the stack's);
    lanes past it are padding. With `sum_mode="sequential"` the result is
    bitwise `server.aggregate_stacked`'s mean on the real lanes."""
    if lanes is None:
        lanes = (stacked.total if isinstance(stacked, LaneShard)
                 else tree_lib.leaves(stacked)[0].shape[0])
    return _mesh_mean_fn(group, sum_mode, lanes)(stacked, weights)


@functools.lru_cache(maxsize=None)
def _mesh_mean_fn(group, sum_mode: str, lanes: int):
    """The lane fold over `group`'s ranks for `lanes` real lanes."""
    def fold(stacked, weights):
        local, total = _place_lanes(stacked, group)
        device = tree_lib.leaves(local)[0].device
        if sum_mode == "sequential":
            full = gather_lanes(local, total, group)
            real = tree_lib.map(lambda x: x[:lanes], full)
            return server_lib._sequential_weighted_sum(
                real, server_lib._normalized(weights, device))
        w_pad = np.zeros(total, np.float32)
        w_pad[:lanes] = np.asarray(weights, np.float64)
        w = torch.as_tensor(w_pad[_block(total, group)], device=device)
        w_total = all_reduce_sum(torch.sum(w), group)
        partial = server_lib._pairwise_weighted_sum(local, w / w_total)
        return tree_lib.map(lambda x: all_reduce_sum(x, group), partial)

    return recompile_lib.register("fed.aggregate.mesh", fold)


def aggregate_stacked_mesh(state, cfg, stacked, weights, group,
                           participant_ids: Optional[Sequence[int]] = None,
                           slot_weights=None, lanes: Optional[int] = None):
    """`server.aggregate_stacked` with the lane fold spread over the ranks.

    `stacked` carries the participant lanes in the order of `weights` /
    `participant_ids`, optionally followed by padding lanes (`lanes` = the
    real count): a whole stack, or the single-cohort round's `LaneShard`.
    The m-independent tail (the η_s step, fedopt's optimizer) is the
    server's, so under `sum_mode="sequential"` the step is bitwise the
    single-process stacked path."""
    have = (stacked.total if isinstance(stacked, LaneShard)
            else tree_lib.leaves(stacked)[0].shape[0])
    lanes = have if lanes is None else lanes
    if lanes == 0:
        return state
    if np.asarray(weights).shape[0] != lanes:
        raise ValueError(f"{np.asarray(weights).shape[0]} weights for "
                         f"{lanes} stacked lanes")

    if cfg.aggregator in ("fedavg", "fedopt"):
        server_lib._check_weights(weights)
        mean = mesh_weighted_mean(stacked, weights, group, cfg.sum_mode,
                                  lanes=lanes)
        if cfg.aggregator == "fedopt":
            return server_lib._fedopt_tail(state, cfg, mean)
        return server_lib.ServerState(
            server_lib._apply_delta(state.params, mean, cfg.server_lr),
            state.opt_state, state.memory)

    # fedmem: a reduction over ALL m_total memory slots, not a lane fold —
    # gather the decoded stack and reuse the single-process step
    if isinstance(stacked, LaneShard):
        stacked = gather_lanes(stacked.local, stacked.total, group)
    stacked = tree_lib.map(lambda a: a[:lanes], stacked)
    return server_lib.aggregate_stacked(state, cfg, stacked, weights,
                                        participant_ids,
                                        slot_weights=slot_weights)
