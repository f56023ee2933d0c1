"""Tree optimizers (port of `repro.optimizer.optim`): AdamW, SGD(+momentum),
LR schedules, global-norm clipping.

Same (init, update) contract and the same update order as the reference:

    opt = adamw(lr=schedule, weight_decay=0.1)
    opt_state = opt.init(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = apply_updates(params, updates)

`update` also takes the clip's factor, `scale=` (a 0-d tensor, as
`clip_scale` gives it): the gradients are multiplied by it inside the
update, as `clip_by_global_norm` would first (the train steps pass it and
never build the clipped tree). The global norm and each leaf's update run
through `kernels.ops` (`sum_squares`, `adamw_update`, `sgd_update`): on a
CPU or `meta` tensor the plain maps, on the card one kernel a leaf
(`csrc/optim.cu`).

`torch.optim.AdamW` is not used: it applies weight decay to the parameter
before the moment step, which is a different update.
States are dicts of tensors plus an int32 `step` tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import ops

Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """v as a 0-d f32 tensor on like's device, filled there: no copy from
    the host, which a captured train step cannot hold."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _lr_at(lr: ScalarOrSchedule, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else _f32(lr, step)


# ---------------------------------------------------------------------------
# Schedules (step: int32 tensor → f32 tensor)
# ---------------------------------------------------------------------------
def constant_schedule(value: float) -> Schedule:
    return lambda step: _f32(value, step)


def cosine_schedule(peak: float, total_steps: int,
                    floor: float = 0.0) -> Schedule:
    def fn(step):
        frac = torch.clamp(step.to(torch.float32) / max(total_steps, 1),
                           0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0) -> Schedule:
    cos = cosine_schedule(peak, max(total_steps - warmup_steps, 1), floor)

    def fn(step):
        warm = peak * step.to(torch.float32) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))
    return fn


# ---------------------------------------------------------------------------
# Gradient clipping
# ---------------------------------------------------------------------------
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(ops.sum_squares(tree_lib.leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The clip's factor min(1, max_norm / max(norm, 1e-12)), 0-d."""
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return tree_lib.map(lambda x: (x * scale).to(x.dtype), tree), norm


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, scale=None) -> (updates, state)


def apply_updates(params, updates):
    return tree_lib.map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _zeros_like_f32(params):
    return tree_lib.map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _unzip(spec, outs: list, k: int) -> tuple:
    """k trees of `spec` from the per-leaf k-tuples `outs`."""
    return tuple(tree_lib.unflatten(spec, [o[i] for o in outs])
                 for i in range(k))


def _step0(params) -> torch.Tensor:
    dev = tree_lib.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": _zeros_like_f32(params), "nu": _zeros_like_f32(params),
                "step": _step0(params)}

    def update(grads, state, params, scale=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        stepf = step.to(torch.float32)
        c1 = 1 - torch.pow(_f32(b1, step), stepf)
        c2 = 1 - torch.pow(_f32(b2, step), stepf)
        g, spec = tree_lib.flatten(grads)
        outs = [ops.adamw_update(*leaf, lr_t, c1, c2, scale, b1=b1, b2=b2,
                                 eps=eps, weight_decay=weight_decay)
                for leaf in zip(g, *(tree_lib.flatten_up_to(spec, t) for t in
                                     (state["mu"], state["nu"], params)))]
        updates, mu, nu = _unzip(spec, outs, 3)
        return updates, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init, update)


def sgd(lr: ScalarOrSchedule, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["vel"] = _zeros_like_f32(params)
        return state

    def update(grads, state, params, scale=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        g, spec = tree_lib.flatten(grads)
        vel = (tree_lib.flatten_up_to(spec, state["vel"]) if momentum
               else [None] * len(g))
        outs = [ops.sgd_update(g_, v, p, lr_t, scale, momentum=momentum,
                               nesterov=nesterov)
                for g_, v, p in zip(g, vel,
                                    tree_lib.flatten_up_to(spec, params))]
        updates, vel = _unzip(spec, outs, 2)
        if not momentum:
            return updates, {"step": step}
        return updates, {"step": step, "vel": vel}

    return Optimizer(init, update)
