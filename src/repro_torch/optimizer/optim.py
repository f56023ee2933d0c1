"""Tree optimizers (port of `repro.optimizer.optim`): AdamW, SGD(+momentum),
LR schedules, global-norm clipping.

Same (init, update) contract and the same update order as the reference:

    opt = adamw(lr=schedule, weight_decay=0.1)
    opt_state = opt.init(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = apply_updates(params, updates)

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
    total = 0
    for x in tree_lib.leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree_lib.map(lambda x: (x * scale).to(x.dtype), tree), norm


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    return tree_lib.map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _zeros_like_f32(params):
    return tree_lib.map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _step0(params) -> torch.Tensor:
    dev = tree_lib.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": _zeros_like_f32(params), "nu": _zeros_like_f32(params),
                "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        mu = tree_lib.map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                          state["mu"], grads)
        nu = tree_lib.map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.float()), state["nu"], grads)
        stepf = step.to(torch.float32)
        c1 = 1 - torch.pow(_f32(b1, step), stepf)
        c2 = 1 - torch.pow(_f32(b2, step), stepf)

        def upd(m, v, p):
            m_hat, v_hat = m / c1, v / c2
            u = -lr_t * (m_hat / (torch.sqrt(v_hat) + eps)
                         + weight_decay * p.float())
            return u.to(p.dtype)

        updates = tree_lib.map(upd, mu, nu, params)
        return updates, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init, update)


def sgd(lr: ScalarOrSchedule, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["vel"] = _zeros_like_f32(params)
        return state

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if not momentum:
            updates = tree_lib.map(
                lambda g, p: (-lr_t * g.float()).to(p.dtype), grads, params)
            return updates, {"step": step}
        vel = tree_lib.map(lambda v, g: momentum * v + g.float(),
                           state["vel"], grads)
        if nesterov:
            updates = tree_lib.map(
                lambda v, g, p: (-lr_t * (momentum * v + g.float())
                                 ).to(p.dtype), vel, grads, params)
        else:
            updates = tree_lib.map(lambda v, p: (-lr_t * v).to(p.dtype),
                                   vel, params)
        return updates, {"step": step, "vel": vel}

    return Optimizer(init, update)
