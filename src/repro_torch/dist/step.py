"""Train step with compressed gradient consensus, ZeRO-1, and the serve
step (port of `repro.dist.step`).

Strategies (GradCompConfig.strategy), as in the reference:

  psum             exact f32 mean of the gradients (no compression).
  psum_decoded     each worker round-trips its own gradients through the
                   NDSC codec, then the f32 mean of the DECODED gradients.
  allgather_packed the paper's consensus: all-gather the PACKED payloads,
                   decode all m, take the mean.
  alltoall_zero1   ZeRO-1 (`make_zero_train_step`): compressed
                   reduce-scatter by all-to-all; each worker updates only
                   its owned rows, and the optimizer state is 1/m per
                   worker. Bitwise `allgather_packed` under shared
                   randomness.

Error feedback is per worker: e ← (g + e) − D(E(g + e)), decoded from the
worker's OWN payload. Each rank holds its own (1, …) view of the
reference's (m, …) EF leaves.

Workers are the ranks of `group` (`repro_torch.dist.sharding`): every rank
runs the same step on the global batch, takes its rows (`shard_batch`) and
meets the others only in the consensus. `group=None` is one worker with no
collective. The params path is exact across ranks: the gathered words and
the all-to-all move bits, and the worker mean is a left-to-right fold
(`sharding.fold_mean`), so every rank updates the same params bit for bit.
The loss (`pmean`), `psum`, `psum_decoded` and ZeRO-1's grad norm are
`all_reduce` sums in the backend's order.

Observability, as in the reference: the returned step callables carry
host-side instrumentation. With a `repro_torch.obs` session active, each
call runs under a "dist.step" (or "dist.step.zero1") span and emits
per-step counters of the ANALYTIC per-worker payload bytes
(`gradcomp.wire_bytes_tree` over the model's parameter shapes, computed
once at factory time). Disabled, the wrapper costs one global load per
call; the program registers with `obs.recompile` under the span's name.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.codecs import stages as codec_stages
from repro_torch.dist import gradcomp as G
from repro_torch.dist import sharding
from repro_torch.dist import zero as zero_lib
from repro_torch.models import decode as decode_lib
from repro_torch.models import model as model_lib
from repro_torch.obs import core as obs_lib
from repro_torch.obs import recompile as recompile_lib
from repro_torch.optimizer.optim import clip_by_global_norm, global_norm


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """A state leaf's global shape and dtype, and the dim split over the
    workers (None: every rank holds the whole leaf)."""

    shape: tuple
    dtype: torch.dtype
    split: Optional[int] = None

    def local_shape(self, num_workers: int) -> tuple:
        """The shape one rank holds."""
        if self.split is None:
            return self.shape
        s = list(self.shape)
        s[self.split] //= num_workers
        return tuple(s)


def _round_idx(opt_state) -> int:
    """Per-step salt for the codec's stochastic parts (dither / keep-mask):
    the optimizer's step count before this step."""
    if isinstance(opt_state, dict) and "step" in opt_state:
        return int(opt_state["step"])
    return 0


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The reference's `pmean` over the workers (identity at one)."""
    if group is None:
        return x
    m = torch.tensor(float(sharding.num_workers(group)), dtype=x.dtype,
                     device=x.device)
    return sharding.all_reduce_sum(x, group).div_(m)


def _meta_params(cfg):
    """The model's parameter tree as `meta` tensors (shapes, dtypes), the
    NamedTuple subtrees of the Mamba and xLSTM blocks kept."""
    shapes, spec = tree_lib.flatten(model_lib.param_shapes(cfg),
                                    is_leaf=model_lib.is_shape)
    return tree_lib.unflatten(spec, [
        torch.empty(s, dtype=cfg.compute_dtype, device="meta")
        for s in shapes])


def _analytic_payload_bytes(cfg, gc: G.GradCompConfig, group):
    """Per-worker bytes on the wire per step, from the audit over the
    model's parameter shapes (None when they can't be built)."""
    try:
        wire = G.wire_bytes_tree(_meta_params(cfg), gc,
                                 sharding.num_workers(group))
        if gc.strategy == "psum":
            return float(wire["f32_bytes"])
        return float(wire["payload_bytes"])
    except Exception:
        return None


def _with_obs(fn, name: str, gc: G.GradCompConfig, payload_bytes):
    """Host-side instrumentation around a train step; call-transparent
    (same signature, same outputs)."""
    recompile_lib.register(name, fn, wire_bytes_per_call=payload_bytes)

    def stepper(params, opt_state, ef, batch):
        if not obs_lib.enabled():
            return fn(params, opt_state, ef, batch)
        obs_lib.observe_program_call(name, fn,
                                     (params, opt_state, ef, batch),
                                     wire_bytes=payload_bytes)
        with obs_lib.span(name, strategy=gc.strategy):
            out = fn(params, opt_state, ef, batch)
        obs_lib.counter("dist.steps", 1, strategy=gc.strategy)
        if payload_bytes is not None:
            obs_lib.counter("dist.payload_bytes", payload_bytes,
                            strategy=gc.strategy)
        return out

    return stepper


def _grads(loss_of, leaves, spec, batch):
    """(loss, [gradient leaf, ...]) of `loss_of(params, batch)` by
    autograd, in flatten order."""
    diff = [p if p.requires_grad else p.detach().requires_grad_()
            for p in leaves]
    loss = loss_of(tree_lib.unflatten(spec, diff), batch)
    return loss.detach(), list(torch.autograd.grad(loss, diff))


# ---------------------------------------------------------------------------
# Consensus
# ---------------------------------------------------------------------------
def _consensus_leaves(g_leaves: list, e_leaves, gc: G.GradCompConfig,
                      round_idx: int, group) -> list:
    """The consensus of each gradient leaf, in flatten order. Consumes
    `g_leaves` (an entry is dropped once read, so a leaf's gradient is
    freed as its consensus is made) and writes each EF residual into its
    leaf of `e_leaves` (the local EF, no worker axis) in place."""
    m = sharding.num_workers(group)
    leaf_codec = codec_stages.ndsc_leaf(gc)
    outs = []
    for i in range(len(g_leaves)):
        g, g_leaves[i] = g_leaves[i], None
        if gc.strategy == "psum":
            outs.append(_pmean(g, group))
            continue
        e = e_leaves[i] if gc.uses_ef else None
        dtype, size, shape = g.dtype, g.numel(), g.shape
        u = g.to(torch.float32) + (e if e is not None else 0.0)
        del g
        resid = None
        if gc.strategy == "allgather_packed" and gc.uses_ef:
            # fused encode + EF: the kernel decodes its own payload and
            # emits u − D(E(u)) alongside — no second decode pass
            payload, resid = leaf_codec.encode_ef(u, i, round_idx)
        else:
            payload = leaf_codec.encode(u, i, round_idx)
        if gc.strategy == "psum_decoded":
            d_own = leaf_codec.decode(payload, i, size, shape, torch.float32)
            cons = _pmean(d_own, group)
            if e is not None:
                resid = u - d_own
        else:  # allgather_packed: (m, …) payloads in rank order
            u = None
            gathered = {k: sharding.all_gather_stack(t, group)
                        for k, t in payload.items()}
            # each worker's payload decoded and folded in as it comes
            # (bitwise the stacked decode, which decodes row by row): the
            # m-fold decode of a vocab-sized leaf would not fit beside the
            # other ranks of a shared card
            cons = sharding.fold_mean(
                (leaf_codec.decode({k: t[w] for k, t in gathered.items()},
                                   i, size, shape, torch.float32)
                 for w in range(m)), m)
        outs.append(cons.to(dtype))
        if e is not None:
            e.copy_(resid)
    return outs


def _consensus(grads, ef, gc: G.GradCompConfig, round_idx: int, group=None):
    """Returns (consensus grads, EF state): `ef` is the local EF tree (no
    worker axis), whose leaves take the new residuals in place."""
    g_leaves, spec = tree_lib.flatten(grads)
    outs = _consensus_leaves(g_leaves, tree_lib.leaves(ef), gc, round_idx,
                             group)
    return tree_lib.unflatten(spec, outs), ef


# ---------------------------------------------------------------------------
# Replicated-parameter train step (psum / psum_decoded / allgather_packed)
# ---------------------------------------------------------------------------
def make_train_step(cfg, opt, gc: G.GradCompConfig, group=None,
                    clip_norm=None, loss_fn=None):
    """(params, opt_state, ef, global batch) → (params, opt_state, ef,
    metrics). Every rank holds the whole params, optimizer state and its
    own (1, …) EF leaves; the batch's dim 0 is split over the workers.

    The parameter and EF tensors are updated IN PLACE (p += u, the same
    rounding as the reference's p + u; e ← the new residual), which saves
    params-sized copies; the returned trees hold the same tensors."""
    if gc.strategy == "alltoall_zero1":
        raise ValueError("strategy 'alltoall_zero1' needs "
                         "make_zero_train_step")
    loss_of = loss_fn or (lambda p, b: model_lib.loss_fn(cfg, p, b))

    def step(params, opt_state, ef, batch):
        leaves, spec = tree_lib.flatten(params)
        loss, g_leaves = _grads(loss_of, leaves, spec,
                                sharding.shard_batch(batch, group))
        loss = _pmean(loss, group)
        e_local = [e[0] for e in tree_lib.leaves(ef)]
        grads = tree_lib.unflatten(spec, _consensus_leaves(
            g_leaves, e_local, gc, _round_idx(opt_state), group))
        if clip_norm is not None:
            grads, grad_norm = clip_by_global_norm(grads, clip_norm)
        else:
            grad_norm = global_norm(grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        with torch.no_grad():
            for p, u in zip(leaves, tree_lib.leaves(updates)):
                p.add_(u.to(p.dtype))
        return params, opt_state, ef, {"loss": loss, "grad_norm": grad_norm}

    return _with_obs(step, "dist.step", gc,
                     _analytic_payload_bytes(cfg, gc, group))


def _specs(tree, split=None):
    return tree_lib.map(
        lambda x: StateSpec(tuple(x.shape), x.dtype, split), tree)


def _state_specs_like(state, params, split):
    """Optimizer-state specs: subtrees structured like the params (mu / nu
    / vel) take the params' `split`; everything else is replicated."""
    pspec = tree_lib.flatten(params)[1]
    if not isinstance(state, dict):
        return _specs(state)
    return {k: _specs(v, split if tree_lib.flatten(v)[1] == pspec else None)
            for k, v in state.items()}


def train_state_specs(cfg, opt, gc: G.GradCompConfig, group=None):
    """StateSpec trees for (params, opt_state, ef) of `init_train_state`:
    params and optimizer state whole on every rank, EF (m, …) split on
    dim 0."""
    params = _meta_params(cfg)
    m = sharding.num_workers(group)
    ef = (tree_lib.map(lambda x: StateSpec((m,) + tuple(x.shape),
                                           torch.float32, 0), params)
          if gc.uses_ef else {})
    return _specs(params), _state_specs_like(opt.init(params), params,
                                             None), ef


def init_train_state(cfg, opt, gc: G.GradCompConfig, group=None,
                     seed: int = 0, device=None):
    """Materialized (params, opt_state, ef) on `device` (`cuda` unless
    asked for the CPU); EF leaves are this rank's (1, *param shape) f32
    zeros when the strategy uses error feedback. Every rank must derive
    the same params from `seed`: one `all_reduce` of a checksum raises
    otherwise."""
    params = model_lib.init_params(seed, cfg, resolve_device(device))
    sharding.check_replicas_equal(params, group)
    opt_state = opt.init(params)
    ef = (tree_lib.map(lambda p: torch.zeros(
        (1,) + tuple(p.shape), dtype=torch.float32, device=p.device),
        params) if gc.uses_ef else {})
    return params, opt_state, ef


# ---------------------------------------------------------------------------
# ZeRO-1 train step (alltoall_zero1)
# ---------------------------------------------------------------------------
def make_zero_train_step(cfg, opt, gc: G.GradCompConfig, group=None,
                         gather_dtype=None, clip_norm=None, loss_fn=None):
    """ZeRO-1 step over OWNED-layout state (see `repro_torch.dist.zero`):
    (owned params, opt_state, ef, global batch) → the same plus metrics.

    A rank holds its rows (rows, chunk) f32 of each leaf's owned layout,
    their optimizer state and its (1, padded_chunks, chunk) EF; the params
    are all-gathered for the forward pass (`gather_dtype` optionally casts
    them for that gather; None keeps the step bitwise `allgather_packed`).
    The owned params and the EF are updated in place."""
    m = sharding.num_workers(group)
    r = sharding.worker_index(group)
    chunk = gc.chunk
    loss_of = loss_fn or (lambda p, b: model_lib.loss_fn(cfg, p, b))
    spec, infos = zero_lib.params_meta(_meta_params(cfg), gc, m)

    def step(owned_params, opt_state, ef, batch):
        owned_leaves = tree_lib.flatten_up_to(spec, owned_params)
        full = []
        for owned, (size, shape, dtype, _) in zip(owned_leaves, infos):
            g = owned if gather_dtype is None else owned.to(gather_dtype)
            if m > 1:
                g = sharding.all_gather_stack(g, group).reshape(-1, chunk)
            full.append(zero_lib.from_owned(g.to(torch.float32), size,
                                            shape, dtype))
        loss, g_leaves = _grads(loss_of, full, spec,
                                sharding.shard_batch(batch, group))
        del full
        loss = _pmean(loss, group)
        round_idx = _round_idx(opt_state)

        e_leaves = (tree_lib.flatten_up_to(spec, ef) if gc.uses_ef
                    else [None] * len(g_leaves))
        owned_grads = []
        sq_sum = torch.zeros((), dtype=torch.float32,
                             device=g_leaves[0].device)
        for i, (e, (size, shape, dtype, (padded, rows))) in enumerate(
                zip(e_leaves, infos)):
            g, g_leaves[i] = g_leaves[i], None
            u = zero_lib.to_owned(g, chunk, m)
            del g
            if e is not None:
                u = u + e[0]
            mean_own, d_own = zero_lib.compressed_reduce_scatter(
                u, i, gc, group, m, round_idx,
                logical_chunks=-(-size // chunk))
            # zero the padding coords so optimizer state / EF stay clean and
            # the norms match the replicated path exactly
            pos = ((r * rows + torch.arange(rows, device=u.device))[:, None]
                   * chunk + torch.arange(chunk, device=u.device)[None, :])
            mean_own = mean_own * (pos < size).to(torch.float32)
            owned_grads.append(mean_own)
            sq_sum = sq_sum + torch.sum(torch.square(mean_own))
            if e is not None:
                e[0].copy_((u - d_own) * zero_lib.valid_mask(
                    size, padded, chunk, u.device))
        grad_norm = torch.sqrt(sharding.all_reduce_sum(sq_sum, group))
        owned_grads = tree_lib.unflatten(spec, owned_grads)
        if clip_norm is not None:
            scale = torch.clamp(clip_norm / torch.clamp_min(grad_norm, 1e-12),
                                max=1.0)
            owned_grads = tree_lib.map(lambda x: x * scale, owned_grads)
        updates, opt_state = opt.update(owned_grads, opt_state, owned_params)
        with torch.no_grad():
            for p, u in zip(owned_leaves, tree_lib.leaves(updates)):
                p.add_(u.to(p.dtype))
        return owned_params, opt_state, ef, {"loss": loss,
                                             "grad_norm": grad_norm}

    return _with_obs(step, "dist.step.zero1", gc,
                     _analytic_payload_bytes(cfg, gc, group))


def _owned_templates(cfg, gc: G.GradCompConfig, m: int):
    spec, infos = zero_lib.params_meta(_meta_params(cfg), gc, m)
    return spec, infos, tree_lib.unflatten(spec, [
        torch.empty((pc, gc.chunk), dtype=torch.float32, device="meta")
        for (_, _, _, (pc, _)) in infos])


def zero_state_specs(cfg, opt, gc: G.GradCompConfig, group=None):
    """StateSpec trees for the owned-layout (params, opt_state, ef) of
    `init_zero_state`: owned (padded_chunks, chunk) and EF (m,
    padded_chunks, chunk) f32, each split over the workers on dim 0."""
    m = sharding.num_workers(group)
    spec, infos, owned = _owned_templates(cfg, gc, m)
    ef = (tree_lib.unflatten(spec, [
        StateSpec((m, pc, gc.chunk), torch.float32, 0)
        for (_, _, _, (pc, _)) in infos]) if gc.uses_ef else {})
    return (_specs(owned, 0), _state_specs_like(opt.init(owned), owned, 0),
            ef)


def init_zero_state(cfg, opt, gc: G.GradCompConfig, group=None,
                    seed: int = 0, device=None):
    """This rank's owned-layout (params, opt_state, ef): the same init as
    `init_train_state` (so both paths start from identical parameters),
    cut to the rank's rows; the ranks' params are checked equal first."""
    m = sharding.num_workers(group)
    r = sharding.worker_index(group)
    params = model_lib.init_params(seed, cfg, resolve_device(device))
    sharding.check_replicas_equal(params, group)

    def own(p):
        o = zero_lib.to_owned(p, gc.chunk, m)
        rows = o.shape[0] // m
        return o[r * rows:(r + 1) * rows].clone()

    owned = tree_lib.map(own, params)
    del params
    opt_state = opt.init(owned)
    ef = (tree_lib.map(lambda o: torch.zeros(
        (1, o.shape[0] * m, gc.chunk), dtype=torch.float32,
        device=o.device), owned) if gc.uses_ef else {})
    return owned, opt_state, ef


# ---------------------------------------------------------------------------
# Serve step
# ---------------------------------------------------------------------------
def make_serve_step(cfg, mesh=None):
    """(params, DecodeState, tokens (B, 1)) → (logits (B, V), state): the
    eager `decode_step` at one worker. `mesh` keeps the reference's
    signature; it must be None or a single device. The reference's serve
    step across workers is GSPMD tensor parallelism over "model", which
    the port has no counterpart for yet (ROADMAP queue 1 item 7). A device
    pins the step: it raises on parameters that live elsewhere."""
    if mesh is None:
        return functools.partial(decode_lib.decode_step, cfg)
    if not isinstance(mesh, (str, torch.device)):
        raise NotImplementedError(
            f"mesh={mesh!r}: only one device is ported so far; serving "
            "across workers is tensor parallelism over 'model' in the "
            "reference, not ported yet (ROADMAP queue 1 item 7)")
    device = resolve_device(mesh)

    def serve_step(params, state, tokens):
        if params["embed"].device != device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"serve step on {device}")
        return decode_lib.decode_step(cfg, params, state, tokens)

    return serve_step


def serve_state_specs(cfg, mesh, global_batch: int, seq_len: int):
    """StateSpec trees for (params, DecodeState, tokens) of the serve step
    at one worker (`mesh` None or a single device, as in
    `make_serve_step`): every leaf whole on the one device."""
    if mesh is not None and not isinstance(mesh, (str, torch.device)):
        raise NotImplementedError(
            f"mesh={mesh!r}: serving state across workers is not ported "
            "yet (ROADMAP queue 1 item 7)")
    state = decode_lib.decode_state_specs(cfg, global_batch, seq_len)
    return (_specs(_meta_params(cfg)),
            decode_lib.DecodeState(caches=_specs(state.caches),
                                   pos=_specs(state.pos)),
            StateSpec((global_batch, 1), torch.int32))
