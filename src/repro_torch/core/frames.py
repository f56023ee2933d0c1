"""Randomized frames S ∈ R^{n×N} (n ≤ N) for (near-)democratic embeddings.

Port of `repro.core.frames`. All frames are (approximately) Parseval,
S Sᵀ = I_n, so the near-democratic embedding is x_nd = Sᵀ y (paper Eq. (8)).

  * Haar random orthonormal — n rows of a Haar-distributed N×N orthogonal
                              matrix (`DenseFrame`).
  * Randomized Hadamard     — S = P D H, stored as signs (D) and kept rows
                              (P); S and Sᵀ run the FWHT, on the card its
                              CUDA kernel (`kernels.ops.fwht`).
  * Sub-Gaussian            — i.i.d. N(0, 1/N) entries (`DenseFrame`).

`hadamard_frame` draws its signs and rows bitwise as the reference does.
`haar_frame` and `subgaussian_frame` are not bitwise: their normal draws
take torch's `log1p` inside XLA's `erf_inv` polynomial, and QR differs
between LAPACK builds (and between LAPACK and cuSOLVER); parity tests
carry the reference's S across
(`convert.frame_from_numpy`). A frame lives on its key's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Union

import torch

from repro_torch import random as rnd
from repro_torch.kernels import ops as kernel_ops


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class DenseFrame:
    """Explicit S ∈ R^{n×N}: Haar orthonormal or sub-Gaussian."""

    S: torch.Tensor  # (n, N)

    @property
    def n(self) -> int:
        return self.S.shape[0]

    @property
    def N(self) -> int:
        return self.S.shape[1]

    @property
    def aspect_ratio(self) -> float:
        return self.N / self.n

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = S x. x: (..., N) → (..., n)."""
        return x @ self.S.T

    def apply_t(self, y: torch.Tensor) -> torch.Tensor:
        """x = Sᵀ y. y: (..., n) → (..., N)."""
        return y @ self.S


@dataclasses.dataclass(frozen=True)
class HadamardFrame:
    """S = P D H with H the normalized N×N Hadamard matrix (±1/√N).

    `signs` is the diagonal of D (±1, int8); `rows` the indices P keeps
    (int32, as the wire has them). Sᵀ y = H D Pᵀ y is one FWHT."""

    signs: torch.Tensor  # (N,) ±1 int8
    rows: torch.Tensor   # (n,) int32 indices into [0, N)
    _index: torch.Tensor = dataclasses.field(init=False, repr=False,
                                             compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_index", self.rows.to(torch.int64))

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
        """y = S x = P (D (H x)). x: (..., N) → (..., n)."""
        dx = kernel_ops.fwht(x) * self.signs.to(x.dtype)
        return torch.index_select(dx, -1, self._index)

    def apply_t(self, y: torch.Tensor) -> torch.Tensor:
        """x = Sᵀ y = H (D (Pᵀ y)). y: (..., n) → (..., N)."""
        z = y.new_zeros(y.shape[:-1] + (self.N,))
        z[..., self._index] = y
        return kernel_ops.fwht(z * self.signs.to(y.dtype))


Frame = Union[DenseFrame, HadamardFrame]


def haar_frame(key: torch.Tensor, n: int, N: int,
               dtype=torch.float32) -> DenseFrame:
    """n random rows of a Haar-distributed N×N orthogonal matrix (paper
    §2.1): QR of a Gaussian matrix, columns sign-corrected by diag(R)."""
    if n > N:
        raise ValueError(f"need n <= N, got {n} > {N}")
    kq, kp = rnd.split2(key)
    q, r = torch.linalg.qr(rnd.normal(kq, (N, N)))
    q = q * torch.sign(torch.diagonal(r))[None, :]
    rows = rnd.permutation(kp, N)[:n].to(torch.int64)
    return DenseFrame(S=q[rows].to(dtype))


def subgaussian_frame(key: torch.Tensor, n: int, N: int,
                      dtype=torch.float32) -> DenseFrame:
    """i.i.d. N(0, 1/N) entries: an approximate Parseval frame (App. J.1)."""
    if n > N:
        raise ValueError(f"need n <= N, got {n} > {N}")
    root = torch.tensor(math.sqrt(N), dtype=torch.float32, device=key.device)
    return DenseFrame(S=(rnd.normal(key, (n, N)) / root).to(dtype))


def hadamard_frame(key: torch.Tensor, n: int,
                   N: int | None = None) -> HadamardFrame:
    """Randomized Hadamard frame S = P D H (paper §2.1), N a power of 2:
    rademacher signs under the first half of a split of the key, the first
    n entries of a permutation of N under the second (all N rows, in order,
    when n == N)."""
    if N is None:
        N = next_pow2(n)
    if not _is_pow2(N):
        raise ValueError(f"Hadamard dimension N={N} must be a power of 2")
    if n > N:
        raise ValueError(f"need n <= N, got {n} > {N}")
    ks, kp = rnd.split2(key)
    signs = rnd.rademacher(ks, (N,), dtype=torch.int8)
    rows = (rnd.permutation(kp, N)[:n] if n < N
            else torch.arange(N, dtype=torch.int32, device=key.device))
    return HadamardFrame(signs=signs, rows=rows)


def make_frame(kind: str, key: torch.Tensor, n: int,
               N: int | None = None) -> Frame:
    """Factory: kind ∈ {'haar', 'hadamard', 'subgaussian'}."""
    if kind == "hadamard":
        return hadamard_frame(key, n, N)
    if N is None:
        N = n
    if kind == "haar":
        return haar_frame(key, n, N)
    if kind == "subgaussian":
        return subgaussian_frame(key, n, N)
    raise ValueError(f"unknown frame kind: {kind!r}")


def dense_matrix(frame: Frame) -> torch.Tensor:
    """S as an explicit (n, N) matrix (tests, small N): for a Hadamard frame
    the columns S e_i, one `apply` of the identity's rows."""
    if isinstance(frame, DenseFrame):
        return frame.S
    eye = torch.eye(frame.N, dtype=torch.float32, device=frame.signs.device)
    return frame.apply(eye).T
