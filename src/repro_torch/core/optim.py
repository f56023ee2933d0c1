"""The paper's optimization algorithms (§4); port of `repro.core.optim`.

  * DGD-DEF  (Alg. 1) — distributed GD with democratically encoded feedback:
      z_t = x̂_t + α e_{t−1};  u_t = ∇f(z_t) − e_{t−1};  v = E(u_t);
      e_t = D(v) − u_t;  x̂_{t+1} = x̂_t − α D(v).
  * DQGD baseline — the same loop with any compressor roundtrip for (E, D).
  * DQ-PSGD  (Alg. 2) — projected stochastic subgradient descent with a
    dithered (unbiased) codec; no error feedback.
  * DQ-PSGD multi-worker (Alg. 3) — consensus mean of per-worker decodes.

Each `lax.scan` of the reference is a Python driver over `steps` calls of
one step program (`repro_torch.graph.Program`, built for the call): on the
card the first call runs the step and captures it into a CUDA graph, and
every later step is one replay. The carry (x̂, e or Σx̂, the range r, the
distance history) is bound by pointer and written in place, so a replay
copies only the step index t, which the step receives as a 0-d tensor;
step t writes its distance at hist[t] on the device. Step t draws under
the reference's key t of `random.split(key, steps)`: the keys go in as a
`random.KeyStack`, each draw the oracle or the codec makes is made for a
block of steps at once outside the graph (the same bits), and the driver
refills a block in place when t enters the next one (`KeyStack.step`).
Nothing in a step reads a value back to the host; the oracles, codecs and
projections a caller passes must not either (on the card the capture
raises, as a concrete read raises inside the reference's `lax.scan`).
`with repro_torch.graph.eager():` runs the same steps uncaptured.

Algorithm 3 runs its m workers as the rows of one batch: one subgradient
call, one encode and one decode per step (for a Hadamard frame, one FWHT
launch each, over m rows).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import graph
from repro_torch import random as rnd
from repro_torch.core.coding import Codec


class Trace(NamedTuple):
    x_final: torch.Tensor
    x_avg: torch.Tensor          # uniform iterate average (PSGD output)
    dist_history: torch.Tensor   # ‖x_t − x*‖₂ per step (‖x_t‖ without x*)


def _dist(x, x_star):
    return torch.linalg.vector_norm(x if x_star is None else x - x_star)


def _const(v, like: torch.Tensor) -> torch.Tensor:
    """v as a tensor divisor on like's device (PyTorch on CUDA turns
    `t / python_float` into a multiply by the reciprocal)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _keys(key: Optional[torch.Tensor], x0: torch.Tensor, steps: int):
    """The per-step keys; with no key, those of key(0) on x0's device. A
    key on another device than x0 is refused: its draws would index x0's
    tensors from that device (a hidden copy, which a capture rejects)."""
    if key is None:
        key = rnd.key(0, device=x0.device)
    if key.device != x0.device:
        raise ValueError(f"the key is on {key.device} but x0 is on "
                         f"{x0.device}: make the key on x0's device")
    return rnd.KeyStack(rnd.split(key, steps))


def _step_index(t, like: torch.Tensor) -> torch.Tensor:
    """Step t as a 0-d int64 tensor on like's device: a step program
    receives it so (`graph.Program` traces an int); under `graph.eager()`
    it is the int, written here by a fill kernel."""
    if isinstance(t, torch.Tensor):
        return t
    return torch.full((), t, dtype=torch.int64, device=like.device)


def _record(hist: torch.Tensor, t: torch.Tensor, d: torch.Tensor) -> None:
    """hist[t] = d on the device."""
    hist.index_copy_(0, t.reshape(1), d.reshape(1))


def _drive(step, steps: int, carry: tuple, keys=None) -> None:
    """`steps` calls of `step(*carry, t)` as one Program binding the
    carry; the key stack's blocks are refilled before each step."""
    program = graph.Program(step, bound=tuple(
        f"[{i}]" for i in range(len(carry))))
    for t in range(steps):
        if keys is not None:
            keys.step(t)
        program(*carry, t)


def _ef_loop(roundtrip, grad_fn, x0, alpha, steps, keys, x_star) -> Trace:
    """The error-feedback loop DGD-DEF and DQGD share."""
    carry = (x0.clone(), torch.zeros_like(x0), x0.new_empty(steps))

    def step(x_hat, e_prev, hist, t):
        t = _step_index(t, x_hat)
        u = grad_fn(x_hat + alpha * e_prev) - e_prev     # error feedback
        q_t = roundtrip(keys.at(t), u)                   # encode + decode
        e_prev.copy_(q_t - u)                            # error for next step
        x_hat.sub_(alpha * q_t)                          # descent step
        _record(hist, t, _dist(x_hat, x_star))

    _drive(step, steps, carry, keys)
    x_hat, _, hist = carry
    return Trace(x_hat, x_hat, hist)


def dgd_def(grad_fn: Callable[[torch.Tensor], torch.Tensor],
            x0: torch.Tensor, codec: Codec, alpha: float, steps: int,
            key: Optional[torch.Tensor] = None,
            x_star: Optional[torch.Tensor] = None) -> Trace:
    """Paper Algorithm 1. `codec` should be deterministic (dithered=False);
    a key is still threaded for the sub-linear mode."""
    return _ef_loop(lambda k, u: codec.decode(codec.encode(u, k)), grad_fn,
                    x0, alpha, steps, _keys(key, x0, steps), x_star)


def dqgd(grad_fn: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
         compressor_roundtrip: Callable, alpha: float, steps: int,
         key: Optional[torch.Tensor] = None,
         x_star: Optional[torch.Tensor] = None) -> Trace:
    """Error-feedback QGD with an arbitrary compressor (the naive baseline)."""
    return _ef_loop(compressor_roundtrip, grad_fn, x0, alpha, steps,
                    _keys(key, x0, steps), x_star)


def dqgd_schedule(grad_fn, x0, levels: int, alpha: float, steps: int,
                  L: float, mu: float, D: float, n: int,
                  x_star=None) -> Trace:
    """DQGD of Lin–Kostina–Hassibi [6] (the paper's Fig. 1b comparator):
    nearest-neighbour quantization on a predefined shrinking range r_t, no
    scale sent; once √n/levels exceeds the contraction the range cannot
    track the error — the √n penalty the democratic embedding removes."""
    rate = min(max(sigma_rate(L, mu), math.sqrt(n) / levels), 1.05)
    carry = (x0.clone(), torch.zeros_like(x0),
             torch.full((), L * D, dtype=x0.dtype, device=x0.device),
             x0.new_empty(steps))
    n_levels = _const(levels, x0)

    def step(x_hat, e_prev, r, hist, t):
        u = grad_fn(x_hat + alpha * e_prev) - e_prev
        delta = 2.0 * r / n_levels
        idx = torch.clamp(torch.floor((torch.clamp(u, -r, r) + r) / delta),
                          0, levels - 1)
        q_t = -r + (2.0 * idx + 1.0) * delta / 2.0
        e_prev.copy_(q_t - u)
        x_hat.sub_(alpha * q_t)
        r.mul_(rate)
        _record(hist, _step_index(t, x_hat), _dist(x_hat, x_star))

    _drive(step, steps, carry)
    x_hat, _, _, hist = carry
    return Trace(x_hat, x_hat, hist)


def gd(grad_fn, x0, alpha, steps, x_star=None) -> Trace:
    """Unquantized gradient descent reference."""
    carry = (x0.clone(), x0.new_empty(steps))

    def step(x, hist, t):
        x.sub_(alpha * grad_fn(x))
        _record(hist, _step_index(t, x), _dist(x, x_star))

    _drive(step, steps, carry)
    x, hist = carry
    return Trace(x, x, hist)


def dq_psgd(subgrad_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
            x0: torch.Tensor, codec: Optional[Codec], alpha: float,
            steps: int, key: torch.Tensor,
            project: Callable[[torch.Tensor], torch.Tensor] = lambda x: x,
            x_star: Optional[torch.Tensor] = None,
            compressor_roundtrip=None) -> Trace:
    """Paper Algorithm 2. `codec` should be dithered (unbiased); a
    `compressor_roundtrip` replaces it (naive baselines), and with neither
    the step is unquantized. Output x̄_T = (1/T)Σ x̂_t."""
    keys = _keys(key, x0, steps)
    carry = (x0.clone(), torch.zeros_like(x0), x0.new_empty(steps))

    def step(x_hat, x_sum, hist, t):
        t = _step_index(t, x_hat)
        ko, kq = rnd.split2(keys.at(t))
        g = subgrad_fn(ko, x_hat)                        # noisy subgradient
        if compressor_roundtrip is not None:
            g = compressor_roundtrip(kq, g)
        elif codec is not None:
            g = codec.decode(codec.encode(g, kq))
        x_hat.copy_(project(x_hat - alpha * g))
        x_sum.add_(x_hat)
        _record(hist, t, _dist(x_hat, x_star))

    _drive(step, steps, carry, keys)
    x_hat, x_sum, hist = carry
    return Trace(x_hat, x_sum / _const(steps, x0), hist)


def dq_psgd_multiworker(subgrad_fns_key: Callable, num_workers: int,
                        x0: torch.Tensor, codec: Optional[Codec],
                        alpha: float, steps: int, key: torch.Tensor,
                        project: Callable[[torch.Tensor], torch.Tensor] = (
                            lambda x: x),
                        x_star: Optional[torch.Tensor] = None,
                        compressor_roundtrip=None) -> Trace:
    """Paper Algorithm 3 (parameter server + m workers).

    `subgrad_fns_key(worker_ids, keys, x)` gets all workers at once: ids
    (m,) int64, keys the stack of the m workers' keys (worker i's is
    `split(k_t, m)[i]`, a `random.StepKey`), and
    returns the (m, n) noisy subgradients, row i worker i's. (The
    reference vmaps a one-worker function over the same ids and keys.)
    Each row is encoded under its worker's key and the server takes the
    mean of the m decodes, then a projected subgradient step."""
    keys = _keys(key, x0, steps)
    ids = torch.arange(num_workers, device=x0.device)
    carry = (x0.clone(), torch.zeros_like(x0), x0.new_empty(steps))

    def step(x_hat, x_sum, hist, t):
        t = _step_index(t, x_hat)
        wkeys = rnd.split(keys.at(t), num_workers)
        g = subgrad_fns_key(ids, wkeys, x_hat)
        if compressor_roundtrip is not None:
            g = compressor_roundtrip(wkeys, g)
        elif codec is not None:
            g = codec.decode(codec.encode(g, wkeys))
        x_hat.copy_(project(x_hat - alpha * torch.mean(g, dim=0)))
        x_sum.add_(x_hat)                                # consensus
        _record(hist, t, _dist(x_hat, x_star))

    _drive(step, steps, carry, keys)
    x_hat, x_sum, hist = carry
    return Trace(x_hat, x_sum / _const(steps, x0), hist)


def alpha_star(L: float, mu: float) -> float:
    """α* = 2/(L+μ) — the optimal GD step size for F_{μ,L,D} (Thm. 2)."""
    return 2.0 / (L + mu)


def sigma_rate(L: float, mu: float) -> float:
    """σ = (L−μ)/(L+μ) — unquantized linear rate / lower-bound floor."""
    return (L - mu) / (L + mu)


def psgd_alpha(D: float, B: float, Ku: float, R: float, T: int) -> float:
    """α = (D/(B·K_u))·√(min{R,1}/T) (Thm. 3)."""
    return (D / (B * Ku)) * (min(R, 1.0) / T) ** 0.5
