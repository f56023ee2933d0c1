"""Rate-allocation policies (port of `repro.fed.budget`): split a global bit
budget across clients / leaves. Host-side numpy, as in the reference.

The paper's codec is optimal for *arbitrary* per-dimension budgets
R ∈ (0, ∞); in the client–server regime the interesting question becomes how
to SPLIT a global per-round budget across heterogeneous clients. With the
NDSC chunked codec the per-client distortion behaves like

    E‖Δ_i − D(E(Δ_i))‖² ≈ ‖Δ_i‖² · 4^{−R_i}            (Thm. 1: error ∝ 2^{−R})

so for a fixed total Σ R_i the aggregate distortion Σ ‖Δ_i‖²·4^{−R_i} is
minimized by water-filling in the log domain — clients with larger update
norms get more bits. Three policies:

  uniform            R_i = R_total / m                 (the homogeneous baseline)
  norm_proportional  R_i ∝ ‖Δ_i‖ (clipped + renormalized to conserve R_total)
  waterfill          greedy ΔR increments to argmax_i ‖Δ_i‖²·4^{−R_i}
                     (exactly minimizes the distortion model above)

All policies conserve the total budget to float precision and respect
[min_rate, max_rate] per-client bounds. `repro_torch.codecs` turns each R_i
into a concrete `GradCompConfig` whose `effective_bits` equals R_i — that
property is the audit unit tying the allocation to the bytes on the wire.

`split_leaf_budgets` applies the same machinery WITHIN one client across the
pytree leaves (cost of a bit differs per leaf: size_l bits buy 1 bit/dim).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch import tree as tree_lib

POLICIES = ("uniform", "norm_proportional", "waterfill")

# greedy water-filling granularity: bits added per increment
_QUANTUM = 1.0 / 64.0


def expected_distortion(norms: Sequence[float],
                        rates: Sequence[float]) -> float:
    """Σ ‖Δ_i‖²·4^{−R_i} — the distortion model the policies optimize."""
    norms = np.asarray(norms, dtype=np.float64)
    rates = np.asarray(rates, dtype=np.float64)
    return float(np.sum(norms ** 2 * 4.0 ** (-rates)))


def allocate(policy: str, total_rate: float, num_clients: int,
             norms: Optional[Sequence[float]] = None,
             min_rate: float = 0.125, max_rate: float = 8.0) -> np.ndarray:
    """Per-client budgets R_i (bits per model dimension), Σ R_i = total_rate.

    `total_rate` is the global per-round budget expressed in bits per model
    dimension summed over clients (total wire bits / model dim); `norms` are
    the (estimated) per-client update norms ‖Δ_i‖ — required by the two
    heterogeneous policies, ignored by `uniform`.
    """
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    m = num_clients
    if m <= 0:
        raise ValueError("num_clients must be positive")
    if not min_rate * m <= total_rate <= max_rate * m:
        raise ValueError(
            f"total_rate={total_rate} outside feasible "
            f"[{min_rate * m}, {max_rate * m}] for m={m} clients")
    if policy == "uniform":
        return np.full(m, total_rate / m)
    if norms is None or len(norms) != m:
        raise ValueError(f"policy {policy!r} needs one norm per client")
    norms = np.maximum(np.asarray(norms, dtype=np.float64), 1e-30)
    if policy == "norm_proportional":
        return _clip_renormalize(total_rate * norms / norms.sum(),
                                 total_rate, min_rate, max_rate)
    return _waterfill(total_rate, norms, min_rate, max_rate)


def _clip_renormalize(rates: np.ndarray, total: float, lo: float,
                      hi: float) -> np.ndarray:
    """Clamp to [lo, hi] and redistribute the imbalance among unclamped
    clients proportionally, preserving Σ R_i = total."""
    rates = rates.copy()
    for _ in range(50):
        clipped = np.clip(rates, lo, hi)
        slack = total - clipped.sum()
        if abs(slack) < 1e-12:
            return clipped
        free = ((clipped > lo) | (slack > 0)) & ((clipped < hi) | (slack < 0))
        if not free.any():
            return clipped
        rates = clipped
        rates[free] += slack * (clipped[free] / max(clipped[free].sum(), 1e-30))
    return np.clip(rates, lo, hi)


def _waterfill(total: float, norms: np.ndarray, lo: float,
               hi: float) -> np.ndarray:
    """Greedy exact water-filling on D(R) = Σ n_i²·4^{−R_i}.

    Marginal gain of a ΔR increment to client i is n_i²·4^{−R_i}(1 − 4^{−ΔR})
    — so each increment goes to argmax n_i²·4^{−R_i}. At convergence the
    marginals equalize for every client strictly inside the bounds.
    """
    m = norms.shape[0]
    rates = np.full(m, lo)
    remaining = total - rates.sum()
    marginal = norms ** 2 * 4.0 ** (-rates)
    capped = rates >= hi - 1e-12
    while remaining > 1e-9 and not capped.all():
        i = int(np.argmax(np.where(capped, -np.inf, marginal)))
        # never step past the per-client cap or the remaining budget
        step = min(_QUANTUM, remaining, hi - rates[i])
        rates[i] += step
        remaining -= step
        marginal[i] *= 4.0 ** (-step)
        capped[i] = rates[i] >= hi - 1e-12
    return rates


# ---------------------------------------------------------------------------
# Adaptive re-allocation — track the CURRENT gradient geometry, not x₀'s
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Re-run the allocator every `realloc_every` rounds from the server-side
    EMA of decoded delta norms (no extra communication — the server already
    decodes every payload).

    `grid` snaps the re-allocated rates to a lattice and `hysteresis` keeps
    the previous allocation unless some client's rate moved by at least that
    much — together they stop cohort keys (and hence the cohorts' lane
    batches) churning every re-allocation while the geometry drifts slowly.
    """

    total_rate: float
    policy: str = "waterfill"
    realloc_every: int = 10
    ema_beta: float = 0.6        # n ← β·n + (1−β)·‖Δ̂‖ per participated round
    hysteresis: float = 0.25     # adopt only if max_i |new_i − cur_i| ≥ this
    grid: float = 0.25           # rate lattice (re-allocated R_i are multiples)
    min_rate: float = 0.25
    max_rate: float = 8.0

    def __post_init__(self):
        if self.realloc_every < 1:
            raise ValueError("realloc_every must be ≥ 1")
        if self.grid <= 0.0:
            raise ValueError("grid must be positive")
        if not 0.0 <= self.ema_beta < 1.0:
            raise ValueError("ema_beta must be in [0, 1)")


class NormEMA:
    """Host-side EMA of per-client decoded delta norms ‖Δ̂_i‖.

    Clients that never participated yet fall back to the mean of the seen
    ones (or 1.0 before any round), so the allocator always gets a full norm
    vector. The first observation initializes the lane (no zero-bias)."""

    def __init__(self, num_clients: int, beta: float = 0.6):
        self.beta = beta
        self.norms = np.zeros(num_clients, dtype=np.float64)
        self.seen = np.zeros(num_clients, dtype=bool)

    def update(self, ids: Sequence[int], norms: Sequence[float]) -> None:
        """One vectorized scatter per round (`ids` are distinct participant
        indices, so the fancy-indexed write never collides) — the per-lane
        norms arrive as one device fetch of m scalars, and this keeps the
        host side O(1) numpy calls rather than an O(m) Python loop."""
        idx = np.asarray(list(ids), dtype=np.intp)
        if idx.size == 0:
            return
        vals = np.asarray(list(norms), dtype=np.float64)
        blended = self.beta * self.norms[idx] + (1.0 - self.beta) * vals
        self.norms[idx] = np.where(self.seen[idx], blended, vals)
        self.seen[idx] = True

    def snapshot(self) -> np.ndarray:
        out = self.norms.copy()
        fill = float(out[self.seen].mean()) if self.seen.any() else 1.0
        out[~self.seen] = fill
        return np.maximum(out, 1e-30)


def quantize_rates(rates: Sequence[float], grid: float, total: float,
                   min_rate: float, max_rate: float) -> np.ndarray:
    """Snap rates to the `grid` lattice, conserving Σ R_i to within grid/2.

    Floor-snap each rate to the lattice (clipped into the feasible lattice
    band), then hand out the remaining whole grid steps by largest fractional
    remainder — deterministic, and every output is a lattice point so equal
    allocations compare exactly across re-allocations (stable cohort keys).
    """
    rates = np.asarray(rates, dtype=np.float64)
    lo = math.ceil(min_rate / grid - 1e-9) * grid
    hi = math.floor(max_rate / grid + 1e-9) * grid
    if lo > hi:
        raise ValueError(f"no lattice point of grid={grid} inside "
                         f"[{min_rate}, {max_rate}]")
    base = np.clip(np.floor(rates / grid + 1e-9), lo / grid, hi / grid)
    units = int(round(total / grid)) - int(base.sum())
    frac = rates / grid - base
    order = np.argsort(-frac, kind="stable")
    step = 1 if units > 0 else -1
    bound = hi / grid if units > 0 else lo / grid
    for _ in range(abs(units)):
        movable = [i for i in (order if units > 0 else order[::-1])
                   if base[i] * step < bound * step]
        if not movable:
            break
        i = movable[0]
        base[i] += step
        frac[i] -= step
        order = np.argsort(-frac, kind="stable")
    return base * grid


def reallocate(cfg: AdaptiveConfig, ema: NormEMA,
               current: Sequence[float]) -> tuple[np.ndarray, bool]:
    """One adaptive step: (rates to use next, whether they changed).

    Runs `allocate(cfg.policy)` on the EMA norms, snaps to the lattice, and
    applies the hysteresis guard: the current allocation is kept unless some
    client's snapped rate moved by ≥ cfg.hysteresis.
    """
    current = np.asarray(current, dtype=np.float64)
    raw = allocate(cfg.policy, cfg.total_rate, current.shape[0],
                   norms=ema.snapshot(), min_rate=cfg.min_rate,
                   max_rate=cfg.max_rate)
    new = quantize_rates(raw, cfg.grid, cfg.total_rate,
                         cfg.min_rate, cfg.max_rate)
    if float(np.max(np.abs(new - current))) < cfg.hysteresis:
        return current, False
    return new, True


def split_leaf_budgets(tree, rate: float,
                       norms: Optional[Sequence[float]] = None,
                       policy: str = "waterfill",
                       min_rate: float = 0.125,
                       max_rate: float = 8.0) -> list:
    """Split ONE client's per-dim budget across its pytree leaves.

    A bit/dim for leaf l costs size_l wire bits, so the greedy criterion
    becomes marginal distortion reduction per wire bit: n_l²·4^{−R_l}/size_l.
    Returns one R_l per leaf (flatten order) with Σ size_l·R_l = rate·Σ size_l
    conserved to the granularity of the greedy quantum.
    """
    leaves = tree_lib.leaves(tree)
    sizes = np.array([int(np.prod(x.shape)) if len(x.shape) else 1
                      for x in leaves], dtype=np.float64)
    if not min_rate <= rate <= max_rate:
        raise ValueError(
            f"rate={rate} outside the feasible [{min_rate}, {max_rate}] "
            f"per-leaf bounds (every leaf is floored at min_rate)")
    if policy == "uniform" or len(leaves) == 1:
        return [rate] * len(leaves)
    if norms is None:
        raise ValueError(f"policy {policy!r} needs one norm per leaf")
    norms = np.maximum(np.asarray(norms, dtype=np.float64), 1e-30)
    total_bits = rate * sizes.sum()
    rates = np.full(len(leaves), min_rate)
    budget = total_bits - (rates * sizes).sum()
    marginal = norms ** 2 * 4.0 ** (-rates) / sizes
    capped = rates >= max_rate
    while budget > 0 and not capped.all():
        i = int(np.argmax(np.where(capped, -np.inf, marginal)))
        step = min(_QUANTUM, budget / sizes[i], max_rate - rates[i])
        if step <= 0:
            break
        rates[i] += step
        budget -= step * sizes[i]
        marginal[i] *= 4.0 ** (-step)
        capped[i] = rates[i] >= max_rate - 1e-12
    return [float(r) for r in rates]
