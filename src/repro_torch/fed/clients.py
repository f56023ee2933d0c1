"""Client-side state and local update loops (port of `repro.fed.clients`).

A client holds an error-feedback memory (DGD-DEF's mechanism, paper Alg. 1,
applied to params-DELTAS), a PRNG lane and a round counter. One round on
client i:

    local   ← local_steps of SGD on the client's shard from params
    Δ_i     ← local − params
    u_i     ← Δ_i + e_i                           (error compensation)
    wire    ← E_i(u_i)          at budget R_i     (a repro_torch.codecs codec)
    e_i     ← u_i − D_i(wire)                     (memory for next round)

When the codec has a fused `encode_ef` (ndsc: the encode_ef kernel on the
card) the last two lines are one call.

A cohort of clients sharing (codec, config) runs as lanes
(`make_cohort_round`): the reference vmaps the round, and the port batches
what the kernels see instead, since a ctypes kernel cannot be traced by
`torch.func.vmap`. Each lane's local SGD runs on its own (so a lane's
arithmetic is the scalar round's, op for op; the lanes' key splits and
mini-batch draws are each one hash for the cohort), then every lane's
compensated delta is encoded in one kernel launch per leaf, each lane under
its own key (`codecs.base.encode_ef_lanes`). Lane l's wire and state are
bitwise the scalar round's on client l.

Both rounds are the reference's jitted programs as captured programs
(`repro_torch.graph.Program`: a CUDA graph per specialization on the
card). Their arguments are copied into the graph's buffers and their
outputs cloned, as the reference's are values; the round index is traced
(a 0-d tensor), so a new round is no new specialization, and a cohort
size is one, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import graph as graph_lib
from repro_torch import random as rnd
from repro_torch import tree as tree_lib
from repro_torch.codecs import base as codec_base


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    """Local-update hyperparameters (shared by a cohort).

    batch_size None runs full-batch local GD; otherwise each local step
    samples `batch_size` examples with replacement from the client shard
    using the client's PRNG lane."""

    local_steps: int = 1
    lr: float = 0.1
    batch_size: Optional[int] = None
    error_feedback: bool = True


class ClientState(NamedTuple):
    ef: Any                     # error-feedback tree (f32, zeros when disabled)
    key: torch.Tensor           # PRNG lane (2,), split every participated round
    rounds_seen: torch.Tensor   # int32 participation counter


def init_client_state(params, key: torch.Tensor,
                      cfg: ClientConfig = ClientConfig()) -> ClientState:
    """Zero EF on the params' device; `key` stays where it is."""
    ef = (tree_lib.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
          if cfg.error_feedback else {})
    return ClientState(ef=ef, key=key, rounds_seen=torch.zeros(
        (), dtype=torch.int32, device=key.device))


def num_examples(data) -> int:
    """Leading-axis length of a client shard (a tree of stacked arrays)."""
    return int(tree_lib.leaves(data)[0].shape[0])


def _batch_rows(keys: torch.Tensor, n: int, cfg: ClientConfig) -> list:
    """Each local step's mini-batch rows, drawn under its step key
    (keys (..., steps, 2) → per step an int64 (..., batch_size)), or None
    per step for full-batch GD. Under a stack of lanes' keys each draw is
    one hash for every lane, lane l's bitwise its own."""
    if cfg.batch_size is None:
        return [None] * cfg.local_steps
    return [rnd.randint(keys[..., t, :], keys.shape[:-2] + (cfg.batch_size,),
                        0, n).to(torch.int64)
            for t in range(cfg.local_steps)]


def _grad(loss_fn: Callable, params, batch):
    """∇ of loss_fn(params, batch) w.r.t. params, by autograd (a third of
    `torch.func.grad`'s host time per call; zeros for unused leaves)."""
    leaves, spec = tree_lib.flatten(params)
    diff = [x.detach().requires_grad_(True) for x in leaves]
    loss = loss_fn(tree_lib.unflatten(spec, diff), batch)
    return tree_lib.unflatten(spec, list(torch.autograd.grad(
        loss, diff, allow_unused=True, materialize_grads=True)))


def _sgd(loss_fn: Callable, params, data, rows: list, cfg: ClientConfig):
    """The local steps, step t on the rows rows[t] (None: the whole
    shard)."""
    p = params
    for idx in rows:
        batch = data if idx is None else tree_lib.map(lambda a: a[idx], data)
        g = _grad(loss_fn, p, batch)
        p = tree_lib.map(
            lambda x, gg: (x - cfg.lr * gg.to(torch.float32)).to(x.dtype),
            p, g)
    return p


def local_sgd(loss_fn: Callable, params, data, key: torch.Tensor,
              cfg: ClientConfig):
    """cfg.local_steps of (mini-batch) SGD on this client's shard: the
    reference's scan over split(key, local_steps), as a loop over the same
    keys; the gradient is autograd's of `loss_fn(params, batch)`."""
    rows = _batch_rows(rnd.split(key, cfg.local_steps), num_examples(data),
                       cfg)
    return _sgd(loss_fn, params, data, rows, cfg)


def _delta(local, global_params):
    return tree_lib.map(
        lambda a, b: a.to(torch.float32) - b.to(torch.float32),
        local, global_params)


def _round_body(loss_fn: Callable, codec, cfg: ClientConfig, meta):
    def fn(global_params, data, state: ClientState, round_idx):
        k_local, k_enc, k_next = rnd.split(state.key, 3)
        local = local_sgd(loss_fn, global_params, data, k_local, cfg)
        delta = _delta(local, global_params)
        u = (tree_lib.map(torch.add, delta, state.ef)
             if cfg.error_feedback else delta)
        if cfg.error_feedback and codec.encode_ef is not None:
            wire, ef = codec.encode_ef(k_enc, u, meta, round_idx)
        elif cfg.error_feedback:
            wire = codec.encode(k_enc, u, round_idx)
            decoded = codec.decode(wire, meta)
            ef = tree_lib.map(torch.subtract, u, decoded)
        else:
            wire = codec.encode(k_enc, u, round_idx)
            ef = state.ef
        return wire, ClientState(ef=ef, key=k_next,
                                 rounds_seen=state.rounds_seen + 1)

    return fn


def _cohort_body(loss_fn: Callable, codec, cfg: ClientConfig, meta):
    def fn(global_params, data, state: ClientState, round_idx):
        lanes = state.key.shape[0]
        ks = rnd.split(state.key, 3)                     # (L, 3, 2)
        k_enc, k_next = ks[:, 1], ks[:, 2]
        rows = _batch_rows(rnd.split(ks[:, 0], cfg.local_steps),
                           int(tree_lib.leaves(data)[0].shape[1]), cfg)
        locals_ = [_sgd(loss_fn, global_params, codec_base.lane(data, i),
                        [r if r is None else r[i] for r in rows], cfg)
                   for i in range(lanes)]
        delta = _delta(codec_base.stack(locals_), global_params)
        u = (tree_lib.map(torch.add, delta, state.ef)
             if cfg.error_feedback else delta)
        if cfg.error_feedback and codec.encode_ef is not None:
            wire, ef = codec_base.encode_ef_lanes(codec, k_enc, u, meta,
                                                  round_idx)
        elif cfg.error_feedback:
            wire = codec_base.encode_lanes(codec, k_enc, u, round_idx)
            decoded = codec_base.decode_lanes(codec, wire, meta, lanes)
            ef = tree_lib.map(torch.subtract, u, decoded)
        else:
            wire = codec_base.encode_lanes(codec, k_enc, u, round_idx)
            ef = state.ef
        return wire, ClientState(ef=ef, key=k_next,
                                 rounds_seen=state.rounds_seen + 1)

    return fn


def make_client_round(loss_fn: Callable, codec, cfg: ClientConfig,
                      params_template) -> Callable:
    """(global_params, data, state, round_idx) → (wire, new state), with the
    codec's static meta taken once from `params_template`: a captured
    program (module docstring)."""
    return graph_lib.Program(_round_body(loss_fn, codec, cfg,
                                         codec.meta(params_template)))


def make_cohort_round(loss_fn: Callable, codec, cfg: ClientConfig,
                      params_template) -> Callable:
    """The client round of a cohort sharing (codec, cfg): (global_params,
    stacked data, stacked states, round_idx) → (stacked wires, stacked
    states). Each lane draws under its own key; the per-leaf frames are
    shared, so the server decodes every lane with the same frames. A
    captured program (module docstring)."""
    return graph_lib.Program(_cohort_body(loss_fn, codec, cfg,
                                          codec.meta(params_template)))


# ---------------------------------------------------------------------------
# Cohort stacking — between the per-client lists and the lanes
# ---------------------------------------------------------------------------
def stack_trees(trees):
    """Stack identically-shaped trees along a new leading axis (client
    states, NamedTuples included, and data shards alike)."""
    return codec_base.stack(list(trees))


def stack_padded(trees, total: int):
    """`stack_trees` padded to `total` lanes by repeating the FIRST tree;
    real lanes come first."""
    if total < len(trees):
        raise ValueError(f"cannot pad {len(trees)} lanes down to {total}")
    return stack_trees(list(trees) + [trees[0]] * (total - len(trees)))


def unstack_tree(tree, m: int) -> list:
    """Inverse of `stack_trees`: lane i of every leaf (views), as m trees."""
    return [codec_base.lane(tree, i) for i in range(m)]


def concat_stacks(stacks: list, perm=None):
    """Concatenate stacked trees along the lane axis, optionally permuting
    the lanes of the result: one concatenate and one gather per leaf. A
    single stack with `perm=None` passes through untouched."""
    out = (stacks[0] if len(stacks) == 1
           else tree_lib.map(lambda *xs: torch.cat(xs, dim=0), *stacks))
    if perm is not None:
        out = tree_lib.map(
            lambda a: a[torch.as_tensor(perm, dtype=torch.int64,
                                        device=a.device)], out)
    return out


def data_signature(data) -> tuple:
    """Hashable (spec, leaf shapes/dtypes): cohort lanes must agree on it
    to stack into one rectangular batch."""
    leaves, spec = tree_lib.flatten(data)
    return spec, tuple((tuple(x.shape), str(x.dtype).replace("torch.", ""))
                       for x in leaves)
