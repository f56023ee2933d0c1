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
collective. `group` may be a ("data", "model") `HostMesh`
(`launch.mesh.make_host_group`): the consensus then runs over the rank's
data group, and the params and optimizer state, held split over "model"
as `train_state_specs` places them (the reference's placement), are
gathered whole at the step's entry and cut back to the rank's slices at
its exit, as the reference's shard_map replicates them over "model"
inside the step. Every model rank of a data group computes the same step,
bitwise the model = 1 step on its data shard. ZeRO-1 keeps its state
replicated over "model", as the reference's does.

The params path is exact across ranks: the gathered words and the
all-to-all move bits, and the worker mean is a left-to-right fold
(`sharding.fold_mean`), so every rank updates the same params bit for bit.
The loss (`pmean`), `psum`, `psum_decoded` and ZeRO-1's grad norm are
`all_reduce` sums in the backend's order.

The serve step (`make_serve_step`) at model > 1 is tensor parallelism over
"model" (`sharding.ModelShard`, `models.decode`): a rank holds its slices
of the params (`init_serve_state` draws them leaf by leaf) and its data
index's slots of the caches, which are whole over "model".

The train steps are the reference's jitted programs as captured programs
(`repro_torch.graph.Program`: a CUDA graph per batch shape and bound
state on the card) at one worker and over an NCCL group. They bind the
params, the optimizer state and the EF by pointer (`STATE_ARGS`) and
update all three IN PLACE, the optimizer's new moments and step count
included (`_into`), so every replay returns the caller's tensors and no
state-sized clone is made; the batch is copied into the graph's buffer.
Unlike the reference's functional step, an `opt_state` passed in holds
the new state afterwards. The step counter reaches the codec as its 0-d
tensor (`_round_idx`), so one specialization serves every step, as in the
reference. Over a gloo group, and on a HostMesh with model > 1, the step
runs eagerly: gloo's collectives are host calls, which a graph cannot
hold.

Observability, as in the reference: the returned step callables carry
host-side instrumentation. With a `repro_torch.obs` session active, each
call runs under a "dist.step" (or "dist.step.zero1") span and emits
per-step counters of the ANALYTIC per-worker payload bytes
(`gradcomp.wire_bytes_tree` over the model's parameter shapes, computed
once at factory time). Disabled, the wrapper costs one global load per
call and a check of the profiler's flag (a running `torch.profiler`
sees the call as a label of the span's name); the program registers with
`obs.recompile` under the span's name (an eager step counts no
specialization), and its first calls' set-up seconds go under it
(`graph.setup_seconds`).

On the card both train steps launch a phase mark (`kernels.marks`) before
the forward, the backward, the consensus, the optimizer and the state
write, and one after the last write: captured, the marks replay in order
inside the step's graph, and a profiler's trace splits the step's device
time into these phases.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import graph as graph_lib
from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.codecs import stages as codec_stages
from repro_torch.dist import gradcomp as G
from repro_torch.dist import sharding
from repro_torch.dist import zero as zero_lib
from repro_torch.kernels import marks as marks_lib
from repro_torch.models import decode as decode_lib
from repro_torch.models import model as model_lib
from repro_torch.obs import core as obs_lib
from repro_torch.obs import recompile as recompile_lib
from repro_torch.optimizer.optim import clip_by_global_norm, global_norm

# a train step's arguments (params, opt_state, ef, batch): the state it
# updates in place, bound by pointer when the step is captured
STATE_ARGS = ("[0]", "[1]", "[2]")


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """A state leaf's global shape and dtype, and its placement: one entry
    per dim, as the reference's PartitionSpec has them, None (whole), an
    axis name, or a tuple of axis names (split over their product).
    `entries` None: every rank holds the whole leaf."""

    shape: tuple
    dtype: torch.dtype
    entries: Optional[tuple] = None

    def local_shape(self, mesh=1) -> tuple:
        """The shape one rank of `mesh` holds: a mesh layout, a process
        group, or an int, the workers along the one "data" axis of a
        process group (`sharding.axis_sizes`)."""
        if self.entries is None:
            return self.shape
        sizes = sharding.axis_sizes(mesh)
        s = list(self.shape)
        for i, e in enumerate(self.entries):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    s[i] //= sizes.get(a, 1)
        return tuple(s)

    def nbytes(self, mesh=1) -> int:
        """Bytes one rank of `mesh` holds."""
        return math.prod(self.local_shape(mesh)) * self.dtype.itemsize


def _round_idx(opt_state):
    """Per-step salt for the codec's stochastic parts (dither / keep-mask):
    the optimizer's step count before this step, its 0-d tensor itself
    (never read on the host), as the reference passes its traced
    `opt_state["step"]`: one captured program serves every step. 0 for a
    state without a count."""
    if isinstance(opt_state, dict) and "step" in opt_state:
        return opt_state["step"]
    return 0


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The reference's `pmean` over the workers (identity at one); the
    count is filled on the device, not copied from the host."""
    if group is None:
        return x
    m = torch.full((), float(sharding.num_workers(group)), dtype=x.dtype,
                   device=x.device)
    return sharding.all_reduce_sum(x, group).div_(m)


def _into(state, new):
    """`new`'s values written into `state`'s tensors, leaf by leaf;
    returns `state`. The train steps update the optimizer state in place,
    so a captured step's bound state is the caller's after every replay."""
    for old, value in zip(tree_lib.leaves(state), tree_lib.leaves(new)):
        old.copy_(value)
    return state


def _device_collectives(group) -> bool:
    """Whether a train step over `group` (its data group) can be a
    captured program: one worker, or an NCCL group, whose collectives are
    queued on the stream. gloo's are host calls, which a CUDA graph cannot
    hold, so a step over gloo runs eagerly."""
    return group is None or (isinstance(group, dist.ProcessGroup)
                             and dist.get_backend(group) == "nccl")


def _program(step, name: str, captured: bool, gc: G.GradCompConfig,
             payload_bytes):
    """The train step as a `graph.Program` binding its state (params,
    optimizer state, EF) by pointer where `captured`, else as it is; with
    the obs wrapper around either."""
    if captured:
        step = graph_lib.Program(step, STATE_ARGS, name=name)
    return _with_obs(step, name, gc, payload_bytes)


def meta_params(cfg):
    """The model's parameter tree as `meta` tensors (shapes, dtypes), the
    NamedTuple subtrees of the Mamba and xLSTM blocks kept."""
    shapes, spec = tree_lib.flatten(model_lib.param_shapes(cfg),
                                    is_leaf=model_lib.is_shape)
    return tree_lib.unflatten(spec, [
        torch.empty(s, dtype=cfg.compute_dtype, device="meta")
        for s in shapes])


def whole_train_state(cfg, group, params, opt_state):
    """(params, opt_state) whole: gathered over "model" from this rank's
    slices on a HostMesh with model > 1 (every rank must call it), as
    they are elsewhere."""
    tp = _model_shard(cfg, group)
    if tp is None:
        return params, opt_state
    whole = tp.gather_tree(params)
    return whole, _params_like(tp.gather_tree, opt_state, whole)


def _analytic_payload_bytes(cfg, gc: G.GradCompConfig, group):
    """Per-worker bytes on the wire per step, from the audit over the
    model's parameter shapes (None when they can't be built)."""
    try:
        wire = G.wire_bytes_tree(meta_params(cfg), gc,
                                 sharding.num_workers(group))
        if gc.strategy == "psum":
            return float(wire["f32_bytes"])
        return float(wire["payload_bytes"])
    except Exception:
        return None


def _with_obs(fn, name: str, gc: G.GradCompConfig, payload_bytes):
    """Host-side instrumentation around a train step; call-transparent
    (same signature, same outputs). `stepper.program` is `fn`."""
    recompile_lib.register(name, fn, wire_bytes_per_call=payload_bytes)

    def stepper(params, opt_state, ef, batch):
        if not obs_lib.enabled():
            with obs_lib.label(name):
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

    stepper.program = fn
    return stepper


def _model_shard(cfg, group):
    """The `ModelShard` by which a train step on a HostMesh with model > 1
    gathers and cuts the params and optimizer state (None otherwise)."""
    if sharding.model_axis_size(group) == 1:
        return None
    if not isinstance(group, sharding.HostMesh):
        raise ValueError("a mesh layout has no ranks to train on "
                         "(make_host_group makes one with ranks)")
    return sharding.ModelShard(meta_params(cfg), group.shape["model"],
                               group.model_index, group.model_group)


def _params_like(fn, state, params):
    """`state` with fn applied to each of its subtrees structured like
    `params` (the optimizer's mu / nu / vel); the rest as it is."""
    if not isinstance(state, dict):
        return state
    pdef = tree_lib.flatten(params)[1]
    return {k: fn(v) if tree_lib.flatten(v)[1] == pdef else v
            for k, v in state.items()}


def _grads(loss_of, leaves, spec, batch):
    """(loss, [gradient leaf, ...]) of `loss_of(params, batch)` by
    autograd, in flatten order; the forward's and the backward's phase
    marks before each."""
    diff = [p if p.requires_grad else p.detach().requires_grad_()
            for p in leaves]
    marks_lib.mark("forward", leaves[0])
    loss = loss_of(tree_lib.unflatten(spec, diff), batch)
    marks_lib.mark("backward", leaves[0])
    return loss.detach(), list(torch.autograd.grad(loss, diff))


# ---------------------------------------------------------------------------
# Consensus
# ---------------------------------------------------------------------------
def _consensus_leaves(g_leaves: list, e_leaves, gc: G.GradCompConfig,
                      round_idx, group) -> list:
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


def _consensus(grads, ef, gc: G.GradCompConfig, round_idx, group=None):
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

    The parameter, optimizer-state and EF tensors are updated IN PLACE
    (p += u, the same rounding as the reference's p + u; e ← the new
    residual; the new moments and step written into the old), which saves
    params-sized copies; the returned trees hold the same tensors. At one
    worker or over NCCL the step is a captured program (module
    docstring).

    On a HostMesh with model > 1 the params and the optimizer's
    params-shaped state are this rank's slices (`init_train_state`): they
    are gathered whole at entry (exact), the step runs over the data
    group, and the new slices are written back (module docstring)."""
    if gc.strategy == "alltoall_zero1":
        raise ValueError("strategy 'alltoall_zero1' needs "
                         "make_zero_train_step")
    loss_of = loss_fn or (lambda p, b: model_lib.loss_fn(cfg, p, b))
    tp = _model_shard(cfg, group)
    payload_bytes = _analytic_payload_bytes(cfg, gc, group)
    group = sharding.data_group(group)

    def step(params, opt_state, ef, batch):
        state = opt_state
        if tp is not None:
            shards, params = params, tp.gather_tree(params)
            opt_state = _params_like(tp.gather_tree, opt_state, params)
        leaves, spec = tree_lib.flatten(params)
        loss, g_leaves = _grads(loss_of, leaves, spec,
                                sharding.shard_batch(batch, group))
        marks_lib.mark("consensus", leaves[0])
        loss = _pmean(loss, group)
        e_local = [e[0] for e in tree_lib.leaves(ef)]
        grads = tree_lib.unflatten(spec, _consensus_leaves(
            g_leaves, e_local, gc, _round_idx(opt_state), group))
        marks_lib.mark("optimizer", leaves[0])
        if clip_norm is not None:
            grads, grad_norm = clip_by_global_norm(grads, clip_norm)
        else:
            grad_norm = global_norm(grads)
        updates, new_state = opt.update(grads, opt_state, params)
        marks_lib.mark("state_write", leaves[0])
        with torch.no_grad():
            for p, u in zip(leaves, tree_lib.leaves(updates)):
                p.add_(u.to(p.dtype))
            if tp is not None:
                for s, p in zip(tree_lib.leaves(shards),
                                tree_lib.leaves(tp.take_tree(params))):
                    s.copy_(p)
                params = shards
                new_state = _params_like(tp.take_tree, new_state, shards)
            _into(state, new_state)
        marks_lib.mark("step_end", leaves[0])
        return params, state, ef, {"loss": loss, "grad_norm": grad_norm}

    return _program(step, "dist.step", tp is None and _device_collectives(
        group), gc, payload_bytes)


def _specs(tree, lead=None):
    """StateSpecs of `tree`'s leaves: dim 0 placed by `lead` (an axis
    entry), the rest whole; `lead` None: whole leaves."""
    return tree_lib.map(
        lambda x: StateSpec(tuple(x.shape), x.dtype, None if lead is None
                            else (lead,) + (None,) * (x.dim() - 1)), tree)


def _placed(tree, entries_tree):
    """StateSpecs of `tree`'s leaves placed by the entries at the same
    positions of `entries_tree` (a `param_specs` tree)."""
    return tree_lib.map(lambda x, e: StateSpec(tuple(x.shape), x.dtype, e),
                        tree, entries_tree)


def _state_specs_like(state, params, entries_tree):
    """Optimizer-state specs: subtrees structured like the params (mu / nu
    / vel) take the params' placement; everything else is whole."""
    pspec = tree_lib.flatten(params)[1]
    if not isinstance(state, dict):
        return _specs(state)
    return {k: (_placed(v, entries_tree)
                if tree_lib.flatten(v)[1] == pspec else _specs(v))
            for k, v in state.items()}


def train_state_specs(cfg, opt, gc: G.GradCompConfig, group=None):
    """StateSpec trees for (params, opt_state, ef) of `init_train_state`,
    the reference's placement: params and their optimizer state split
    over "model" by `param_specs` (whole at model 1), EF (m, …) split over
    the data axes on dim 0."""
    params = meta_params(cfg)
    entries = sharding.param_specs(params, sharding.model_axis_size(group))
    m = sharding.num_workers(group)
    lead = sharding.lead_entry(sharding.data_axis_names(group))
    ef = (tree_lib.map(lambda x: StateSpec(
        (m,) + tuple(x.shape), torch.float32, (lead,) + (None,) * x.dim()),
        params) if gc.uses_ef else {})
    return (_placed(params, entries),
            _state_specs_like(opt.init(params), params, entries), ef)


def init_train_state(cfg, opt, gc: G.GradCompConfig, group=None,
                     seed: int = 0, device=None):
    """Materialized (params, opt_state, ef) on `device` (`cuda` unless
    asked for the CPU); EF leaves are this rank's (1, *param shape) f32
    zeros when the strategy uses error feedback. On a HostMesh with model
    > 1 the params are this rank's slices, drawn leaf by leaf
    (`model.init_params`' `cut`). Every rank of a data group must derive
    the same params from `seed`: one `all_reduce` of a checksum raises
    otherwise."""
    device = resolve_device(device)
    tp = _model_shard(cfg, group)
    params = model_lib.init_params(seed, cfg, device,
                                   cut=None if tp is None else tp.cut)
    sharding.check_replicas_equal(params, sharding.data_group(group))
    opt_state = opt.init(params)
    ef = (tree_lib.map(lambda p: torch.zeros(
        (1,) + tuple(p.shape), dtype=torch.float32, device=device),
        meta_params(cfg)) if gc.uses_ef else {})
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
    The owned params, the optimizer state and the EF are updated in place;
    captured as `make_train_step`'s step is. On a HostMesh the step runs
    over the rank's data group, its state whole over "model"."""
    captured = sharding.model_axis_size(group) == 1
    group = sharding.data_group(group)
    captured = captured and _device_collectives(group)
    m = sharding.num_workers(group)
    r = sharding.worker_index(group)
    chunk = gc.chunk
    loss_of = loss_fn or (lambda p, b: model_lib.loss_fn(cfg, p, b))
    spec, infos = zero_lib.params_meta(meta_params(cfg), gc, m)

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
        marks_lib.mark("consensus", owned_leaves[0])
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
        marks_lib.mark("optimizer", owned_leaves[0])
        grad_norm = torch.sqrt(sharding.all_reduce_sum(sq_sum, group))
        owned_grads = tree_lib.unflatten(spec, owned_grads)
        if clip_norm is not None:
            scale = torch.clamp(clip_norm / torch.clamp_min(grad_norm, 1e-12),
                                max=1.0)
            owned_grads = tree_lib.map(lambda x: x * scale, owned_grads)
        updates, new_state = opt.update(owned_grads, opt_state,
                                        owned_params)
        marks_lib.mark("state_write", owned_leaves[0])
        with torch.no_grad():
            for p, u in zip(owned_leaves, tree_lib.leaves(updates)):
                p.add_(u.to(p.dtype))
            _into(opt_state, new_state)
        marks_lib.mark("step_end", owned_leaves[0])
        return owned_params, opt_state, ef, {"loss": loss,
                                             "grad_norm": grad_norm}

    return _program(step, "dist.step.zero1", captured, gc,
                    _analytic_payload_bytes(cfg, gc, group))


def _owned_templates(cfg, gc: G.GradCompConfig, m: int):
    spec, infos = zero_lib.params_meta(meta_params(cfg), gc, m)
    return spec, infos, tree_lib.unflatten(spec, [
        torch.empty((pc, gc.chunk), dtype=torch.float32, device="meta")
        for (_, _, _, (pc, _)) in infos])


def zero_state_specs(cfg, opt, gc: G.GradCompConfig, group=None):
    """StateSpec trees for the owned-layout (params, opt_state, ef) of
    `init_zero_state`: owned (padded_chunks, chunk) and EF (m,
    padded_chunks, chunk) f32, each split over the data axes on dim 0 and
    whole over "model"."""
    m = sharding.num_workers(group)
    lead = sharding.lead_entry(sharding.data_axis_names(group))
    spec, infos, owned = _owned_templates(cfg, gc, m)
    ef = (tree_lib.unflatten(spec, [
        StateSpec((m, pc, gc.chunk), torch.float32, (lead, None, None))
        for (_, _, _, (pc, _)) in infos]) if gc.uses_ef else {})
    owned_entries = tree_lib.map(lambda _: (lead, None), owned)
    return (_specs(owned, lead),
            _state_specs_like(opt.init(owned), owned, owned_entries), ef)


def init_zero_state(cfg, opt, gc: G.GradCompConfig, group=None,
                    seed: int = 0, device=None):
    """This rank's owned-layout (params, opt_state, ef): the same init as
    `init_train_state` (so both paths start from identical parameters),
    cut to the rank's rows; the ranks' params are checked equal first. On
    a HostMesh, the rank's data index's rows, whole over "model"."""
    group = sharding.data_group(group)
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
def _serve_layout(mesh):
    """`mesh` as the placement functions read it: None for one worker (None
    or a device), else the process group or mesh; anything else raises."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        return None
    if isinstance(mesh, (sharding.MeshLayout, dist.ProcessGroup)):
        return mesh
    raise ValueError(f"mesh={mesh!r}: a serve step takes None, a device, a "
                     "process group of data workers or a mesh "
                     "(launch.mesh.make_host_group)")


def _serve_shard(cfg, layout):
    """The `sharding.ModelShard` the serve step on `layout` runs through:
    this rank's slice of the model at model > 1, and for an MoE config at
    data > 1 the data group its routing gathers the global batch over.
    None where every rank runs the one-worker step on its slots."""
    model = sharding.model_axis_size(layout)
    batch = cfg.num_experts > 0 and sharding.num_workers(layout) > 1
    if model == 1 and not batch:
        return None
    if isinstance(layout, sharding.HostMesh):
        return sharding.ModelShard(
            meta_params(cfg), model, layout.model_index, layout.model_group,
            batch_group=layout.data_group if batch else None,
            batch_index=layout.data_index)
    if isinstance(layout, sharding.MeshLayout):
        raise ValueError("a mesh layout has no ranks to serve on "
                         "(make_host_group makes one with ranks)")
    return sharding.ModelShard(meta_params(cfg), 1, 0, batch_group=layout,
                               batch_index=sharding.worker_index(layout))


def make_serve_step(cfg, mesh=None):
    """(params, DecodeState, tokens (B, 1)) → (logits (B, V), state), as
    the reference's jitted `decode_step`, registered as "dist.serve_step".

    At one worker (`mesh` None or a device) it is the captured
    `decode_step` (`repro_torch.graph.Program`, a CUDA graph per batch
    shape and bound caches); a device pins it: it raises on parameters
    that live elsewhere. Over data workers (a process group) each rank
    runs that program on its own slots: nothing crosses ranks.

    On a HostMesh with model > 1 it is tensor parallelism over "model": a
    rank passes its slices of the params and its data index's slots of
    the state (`init_serve_state`), and gets its slots' whole logits (B /
    data, V). An MoE config at data > 1 (a process group or a HostMesh)
    routes the global batch, as the reference's GSPMD step does: each
    MoE layer gathers the ranks' top-k choices over the data group, and
    the batch must be split over it (`init_serve_state` refuses a batch
    the data axis does not divide). These steps run eagerly: their
    collectives are host calls (gloo, for ranks that share a card, cannot
    be captured in a CUDA graph), so `obs.recompile` counts no
    specialization for them."""
    layout = _serve_layout(mesh)
    if not cfg.decode_supported:
        raise ValueError(f"{cfg.name} is encoder-only: no serve step")
    tp = _serve_shard(cfg, layout)
    if tp is not None:
        return recompile_lib.register("dist.serve_step", functools.partial(
            decode_lib.decode_step, cfg, tp=tp))
    step = recompile_lib.register("dist.serve_step", graph_lib.Program(
        functools.partial(decode_lib.decode_step, cfg),
        decode_lib.IN_PLACE_ARGS))
    if layout is not None or mesh is None:
        return step
    device = resolve_device(mesh)

    def serve_step(params, state, tokens):
        if params["embed"].device != device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"serve step on {device}")
        return step(params, state, tokens)

    return serve_step


def serve_state_specs(cfg, mesh, global_batch: int, seq_len: int):
    """StateSpec trees for (params, DecodeState, tokens) of the serve step,
    the reference's placement: params split over "model" by `param_specs`;
    caches split over the data axes on the batch dim (dim 1) and whole
    over "model", the rotation `signs` whole; `pos` and `tokens` split
    over the data axes. At one worker every leaf is whole."""
    layout = _serve_layout(mesh)
    params = meta_params(cfg)
    entries = sharding.param_specs(params, sharding.model_axis_size(layout))
    axes = () if layout is None else sharding.data_axes_for(global_batch,
                                                            layout)
    first = sharding.lead_entry(axes)
    state = decode_lib.decode_state_specs(cfg, global_batch, seq_len)

    def cache_spec(name, x):
        if name in decode_lib.SHARED_CACHE_KEYS or not axes:
            return StateSpec(tuple(x.shape), x.dtype)
        return StateSpec(tuple(x.shape), x.dtype,
                         (None, first) + (None,) * (x.dim() - 2))

    return (_placed(params, entries),
            decode_lib.DecodeState(
                caches={k: cache_spec(k, v) for k, v in state.caches.items()},
                pos=_specs(state.pos, first)),
            StateSpec((global_batch, 1), torch.int32,
                      (first, None) if axes else None))


def init_serve_state(cfg, mesh, global_batch: int, max_seq: int,
                     seed: int = 0, device=None):
    """One rank's (params, DecodeState) for `make_serve_step(cfg, mesh)`:
    its slices of the seeded params (`model.init_params` with the rank's
    `cut`: drawn leaf by leaf, bitwise the slices of the one-worker init,
    so a rank never holds the whole model) and zero caches for its slots
    (`serve_state_specs`' local batch), on `device` (`cuda` unless asked
    for the CPU)."""
    layout = _serve_layout(mesh)
    _, state, _ = serve_state_specs(cfg, layout, global_batch, max_seq)
    local = state.pos.local_shape(layout)[0]
    if (cfg.num_experts > 0 and local == global_batch
            and sharding.num_workers(layout) > 1):
        raise ValueError(f"{cfg.name} routes the global batch: a batch of "
                         f"{global_batch} must split over the "
                         f"{sharding.num_workers(layout)} data workers")
    cut = None
    if sharding.model_axis_size(layout) > 1:
        cut = sharding.ModelShard(meta_params(cfg), layout.shape["model"],
                                  layout.model_index).cut
    params = model_lib.init_params(seed, cfg, device, cut=cut)
    return params, decode_lib.init_decode_state(cfg, local, max_seq,
                                                device=device)
