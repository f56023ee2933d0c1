"""The paper's optimization algorithms (§4); port of `repro.core.optim`.

  * DGD-DEF  (Alg. 1) — distributed GD with democratically encoded feedback:
      z_t = x̂_t + α e_{t−1};  u_t = ∇f(z_t) − e_{t−1};  v = E(u_t);
      e_t = D(v) − u_t;  x̂_{t+1} = x̂_t − α D(v).
  * DQGD baseline — the same loop with any compressor roundtrip for (E, D).
  * DQ-PSGD  (Alg. 2) — projected stochastic subgradient descent with a
    dithered (unbiased) codec; no error feedback.
  * DQ-PSGD multi-worker (Alg. 3) — consensus mean of per-worker decodes.

Each `lax.scan` of the reference is a Python loop over
`random.split(key, steps)`, so step t draws under the reference's key t;
the keys go in as a `random.KeyStack`, so each draw the oracle or the codec
makes is made once for all steps (the same bits). The distance history is written into a preallocated tensor on x0's device
and nothing in a loop reads a value back to the host, so on the card the
steps queue without a synchronization. Algorithm 3 runs its m workers as
the rows of one batch: one subgradient call, one encode and one decode per
step (for a Hadamard frame, one FWHT launch each, over m rows).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

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
    """The per-step keys; with no key, those of key(0) on x0's device."""
    if key is None:
        key = rnd.key(0, device=x0.device)
    return rnd.KeyStack(rnd.split(key, steps))


def _ef_loop(roundtrip, grad_fn, x0, alpha, steps, keys, x_star) -> Trace:
    """The error-feedback loop DGD-DEF and DQGD share."""
    hist = x0.new_empty(steps)
    x_hat, e_prev = x0, torch.zeros_like(x0)
    for t in range(steps):
        u = grad_fn(x_hat + alpha * e_prev) - e_prev     # error feedback
        q_t = roundtrip(keys.at(t), u)                   # encode + decode
        e_prev = q_t - u                                 # error for next step
        x_hat = x_hat - alpha * q_t                      # descent step
        hist[t] = _dist(x_hat, x_star)
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
    hist = x0.new_empty(steps)
    x_hat, e_prev = x0, torch.zeros_like(x0)
    r = torch.tensor(L * D, dtype=x0.dtype, device=x0.device)
    n_levels = _const(levels, x0)
    for t in range(steps):
        u = grad_fn(x_hat + alpha * e_prev) - e_prev
        delta = 2.0 * r / n_levels
        idx = torch.clamp(torch.floor((torch.clamp(u, -r, r) + r) / delta),
                          0, levels - 1)
        q_t = -r + (2.0 * idx + 1.0) * delta / 2.0
        e_prev = q_t - u
        x_hat = x_hat - alpha * q_t
        r = r * rate
        hist[t] = _dist(x_hat, x_star)
    return Trace(x_hat, x_hat, hist)


def gd(grad_fn, x0, alpha, steps, x_star=None) -> Trace:
    """Unquantized gradient descent reference."""
    hist = x0.new_empty(steps)
    x = x0
    for t in range(steps):
        x = x - alpha * grad_fn(x)
        hist[t] = _dist(x, x_star)
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
    hist = x0.new_empty(steps)
    x_hat, x_sum = x0, torch.zeros_like(x0)
    for t in range(steps):
        ko, kq = rnd.split2(keys.at(t))
        g = subgrad_fn(ko, x_hat)                        # noisy subgradient
        if compressor_roundtrip is not None:
            g = compressor_roundtrip(kq, g)
        elif codec is not None:
            g = codec.decode(codec.encode(g, kq))
        x_hat = project(x_hat - alpha * g)
        x_sum = x_sum + x_hat
        hist[t] = _dist(x_hat, x_star)
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
    hist = x0.new_empty(steps)
    x_hat, x_sum = x0, torch.zeros_like(x0)
    for t in range(steps):
        wkeys = rnd.split(keys.at(t), num_workers)
        g = subgrad_fns_key(ids, wkeys, x_hat)
        if compressor_roundtrip is not None:
            g = compressor_roundtrip(wkeys, g)
        elif codec is not None:
            g = codec.decode(codec.encode(g, wkeys))
        x_hat = project(x_hat - alpha * torch.mean(g, dim=0))   # consensus
        x_sum = x_sum + x_hat
        hist[t] = _dist(x_hat, x_star)
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
