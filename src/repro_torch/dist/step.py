"""Train step with compressed gradient consensus, and the serve step (port
of `repro.dist.step`).

Strategies (GradCompConfig.strategy), as in the reference:

  psum             exact f32 mean of the gradients (no compression).
  psum_decoded     each worker round-trips its own gradients through the
                   NDSC codec, then the f32 mean of the DECODED gradients.
  allgather_packed the paper's consensus: gather the PACKED payloads,
                   decode all m (stacked decode), take the mean.

Error feedback is per worker: e ← (g + e) − D(E(g + e)). EF leaves keep the
reference's leading worker axis (m, …).

This slice runs one worker: the collectives degenerate to a leading axis of
1 (all-gather) and a mean over one value, exactly as the reference does on
a 1×1 mesh. More workers raise until the `torch.distributed` slice.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.codecs import stages as codec_stages
from repro_torch.dist import gradcomp as G
from repro_torch.models import decode as decode_lib
from repro_torch.models import model as model_lib
from repro_torch.optimizer.optim import clip_by_global_norm, global_norm


def _round_idx(opt_state) -> int:
    """Per-step salt for the codec's stochastic parts (dither / keep-mask):
    the optimizer's step count before this step."""
    if isinstance(opt_state, dict) and "step" in opt_state:
        return int(opt_state["step"])
    return 0


def _check_workers(num_workers: int) -> None:
    if num_workers != 1:
        raise NotImplementedError(
            f"num_workers={num_workers}: only one worker is ported so far; "
            "multi-worker consensus waits for the torch.distributed slice")


def _consensus(grads, ef, gc: G.GradCompConfig, round_idx: int):
    """Returns (consensus grads, new EF state) at one worker; `ef` is the
    local EF tree (no worker axis)."""
    if gc.strategy == "psum":
        return grads, ef
    leaf_codec = codec_stages.ndsc_leaf(gc)
    leaves, spec = tree_lib.flatten(grads)
    e_leaves = tree_lib.leaves(ef) if gc.uses_ef else [None] * len(leaves)
    outs, new_e = [], []
    for i, (g, e) in enumerate(zip(leaves, e_leaves)):
        u = g.to(torch.float32) + (e if e is not None else 0.0)
        resid = None
        if gc.strategy == "allgather_packed" and gc.uses_ef:
            # fused encode + EF: the kernel decodes its own payload and
            # emits u − D(E(u)) alongside — no second decode pass
            payload, resid = leaf_codec.encode_ef(u, i, round_idx)
        else:
            payload = leaf_codec.encode(u, i, round_idx)
        if gc.strategy == "psum_decoded":
            d_own = leaf_codec.decode(payload, i, u.numel(), u.shape,
                                      torch.float32)
            cons = d_own
            if gc.uses_ef:
                resid = u - d_own
        else:  # allgather_packed: the gathered worker axis has length 1
            gathered = {k: t[None] for k, t in payload.items()}
            stacked = leaf_codec.decode(gathered, i, u.numel(), u.shape,
                                        torch.float32, extra_lead=1)
            cons = torch.mean(stacked, dim=0)
        outs.append(cons.to(g.dtype))
        if gc.uses_ef:
            new_e.append(resid)
    grads = tree_lib.unflatten(spec, outs)
    return grads, (tree_lib.unflatten(spec, new_e) if gc.uses_ef else ef)


def make_train_step(cfg, opt, gc: G.GradCompConfig, num_workers: int = 1,
                    clip_norm=None, loss_fn=None):
    """(params, opt_state, ef, batch) → (params, opt_state, ef, metrics).

    The parameter tensors are updated IN PLACE (p += u, the same rounding
    as the reference's p + u), which saves a params-sized copy; the
    returned params tree holds the same tensors."""
    if gc.strategy == "alltoall_zero1":
        raise ValueError("strategy 'alltoall_zero1' needs make_zero_train_step"
                         ", which is not ported yet")
    _check_workers(num_workers)
    loss_of = loss_fn or (lambda p, b: model_lib.loss_fn(cfg, p, b))

    def step(params, opt_state, ef, batch):
        leaves, spec = tree_lib.flatten(params)
        diff = [p if p.requires_grad else p.detach().requires_grad_()
                for p in leaves]
        loss = loss_of(tree_lib.unflatten(spec, diff), batch)
        grads = tree_lib.unflatten(spec, torch.autograd.grad(loss, diff))
        loss = loss.detach()
        ef_local = tree_lib.map(lambda e: e[0], ef)
        grads, ef_local = _consensus(grads, ef_local, gc,
                                     _round_idx(opt_state))
        ef = tree_lib.map(lambda e: e[None], ef_local)
        if clip_norm is not None:
            grads, grad_norm = clip_by_global_norm(grads, clip_norm)
        else:
            grad_norm = global_norm(grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        with torch.no_grad():
            for p, u in zip(leaves, tree_lib.leaves(updates)):
                p.add_(u.to(p.dtype))
        return params, opt_state, ef, {"loss": loss, "grad_norm": grad_norm}

    return step


def init_train_state(cfg, opt, gc: G.GradCompConfig, num_workers: int = 1,
                     seed: int = 0, device=None):
    """Materialized (params, opt_state, ef) on `device` (`cuda` unless
    asked for the CPU); EF leaves are (m, *param shape) f32 zeros when the
    strategy uses error feedback."""
    _check_workers(num_workers)
    params = model_lib.init_params(seed, cfg, resolve_device(device))
    opt_state = opt.init(params)
    ef = (tree_lib.map(lambda p: torch.zeros(
        (num_workers,) + tuple(p.shape), dtype=torch.float32,
        device=p.device), params) if gc.uses_ef else {})
    return params, opt_state, ef


def make_serve_step(cfg, mesh=None):
    """(params, DecodeState, tokens (B, 1)) → (logits (B, V), state): the
    eager `decode_step` at one worker. `mesh` keeps the reference's
    signature; it must be None or a single device, since serving across
    workers is not ported yet. A device pins the step: it raises on
    parameters that live elsewhere."""
    if mesh is None:
        return functools.partial(decode_lib.decode_step, cfg)
    if not isinstance(mesh, (str, torch.device)):
        raise NotImplementedError(
            f"mesh={mesh!r}: only one device is ported so far; serving "
            "across workers waits for the torch.distributed slice")
    device = resolve_device(mesh)

    def serve_step(params, state, tokens):
        if params["embed"].device != device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"serve step on {device}")
        return decode_lib.decode_step(cfg, params, state, tokens)

    return serve_step
