"""Randomized Hadamard frame S = D·H at n = N (the codec's frame).

Port of `repro.core.frames.HadamardFrame` / `hadamard_frame` for the case
the NDSC codec uses, n == N: P is the identity. The row-selection branch for
n < N (which needs `jax.random.permutation`) and the dense frames are not
ported yet (ROADMAP, queue 1 item 5).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as rnd
from repro_torch.kernels import ops as kernel_ops


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class HadamardFrame:
    """S = P D H with H the normalized N×N Hadamard matrix; here P = I.

    `signs` is the diagonal of D (±1, int8); `rows` the kept indices."""

    signs: torch.Tensor  # (N,) ±1 int8
    rows: torch.Tensor   # (n,) int32

    @property
    def n(self) -> int:
        return self.rows.shape[0]

    @property
    def N(self) -> int:
        return self.signs.shape[0]

    @property
    def aspect_ratio(self) -> float:
        return self.N / self.n

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = S x = D (H x). x: (..., N) → (..., N)."""
        return kernel_ops.fwht(x) * self.signs.to(x.dtype)

    def apply_t(self, y: torch.Tensor) -> torch.Tensor:
        """x = Sᵀ y = H (D y)."""
        return kernel_ops.fwht(y * self.signs.to(y.dtype))


def hadamard_frame(key: torch.Tensor, n: int,
                   N: int | None = None) -> HadamardFrame:
    """Randomized Hadamard frame (paper §2.1) with the same draws as
    `repro.core.frames.hadamard_frame`: split the key, rademacher signs."""
    if N is None:
        N = next_pow2(n)
    if not _is_pow2(N):
        raise ValueError(f"Hadamard dimension N={N} must be a power of 2")
    if n > N:
        raise ValueError(f"need n <= N, got {n} > {N}")
    if n < N:
        raise NotImplementedError(
            "hadamard_frame with n < N (row permutation) is not ported yet")
    ks, _ = rnd.split(key)
    signs = rnd.rademacher(ks, (N,), dtype=torch.int8)
    rows = torch.arange(N, dtype=torch.int32, device=key.device)
    return HadamardFrame(signs=signs, rows=rows)
