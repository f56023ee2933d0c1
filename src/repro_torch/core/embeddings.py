"""Democratic and near-democratic embeddings (paper §2); port of
`repro.core.embeddings`.

Near-democratic (NDE):   x_nd = Sᵀy   (closed form for Parseval frames, Eq. (8)).
Democratic (DE):         argmin ‖x‖∞ s.t. y = Sx   (Eq. (5)), by the
Lyubarskii–Vershynin iterative truncation [10]: after k rounds the residual
is η^k‖y‖₂ and ‖x‖∞ ≤ η‖y‖₂ / ((1−η)√(δN)) = K_u‖y‖₂/√N.

The reference jits `democratic` (its `fori_loop` of `iters` rounds); here
it is a `repro_torch.graph.Program` over a Python loop of `iters` rounds,
a CUDA graph on the card. Each round is two frame applications (two FWHT
launches for a Hadamard frame), and nothing reads a value back to the
host. The frame's tensors are bound by pointer, so a graph dies with its
frame; `iters`, `eta` and `delta` are static. Called inside another
Program (a captured DGD-DEF step) it runs inline, as a jitted function
called under another trace does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import graph
from repro_torch.core.frames import Frame

# Uncertainty-principle parameters for Haar orthonormal frames with aspect
# ratio λ = 2 (the reference's defaults; K_u ≈ 2.1).
DEFAULT_ETA = 0.65
DEFAULT_DELTA = 0.4


def near_democratic(frame: Frame, y: torch.Tensor) -> torch.Tensor:
    """x_nd = Sᵀ y (paper Eq. (8)). y: (..., n) → (..., N)."""
    return frame.apply_t(y)


def inverse(frame: Frame, x: torch.Tensor) -> torch.Tensor:
    """y = S x — the (linear) decode map shared by DE and NDE."""
    return frame.apply(x)


def democratic(frame: Frame, y: torch.Tensor, eta: float = DEFAULT_ETA,
               delta: float = DEFAULT_DELTA, iters: int = 30) -> torch.Tensor:
    """Kashin/democratic embedding via LV iterative truncation [10, Thm 3.5].

    repeat: u = Sᵀr;  û = clip(u, ±M) with M = η‖r‖₂/√(δN);  x += û;  r −= Sû.
    Then the final residual is folded back through Sᵀ, so y = Sx holds to
    float precision."""
    tensors = tuple(getattr(frame, f.name)
                    for f in dataclasses.fields(frame) if f.init)
    rounds = EmbeddingSpec("democratic", float(eta), float(delta), int(iters))
    return _DEMOCRATIC(tensors, y, type(frame), rounds)


def _democratic(tensors: tuple, y: torch.Tensor, frame_type,
                rounds: "EmbeddingSpec") -> torch.Tensor:
    """`democratic` over the frame rebuilt from its tensors."""
    frame = frame_type(*tensors)
    root = torch.full((), math.sqrt(rounds.delta * frame.N), dtype=y.dtype,
                      device=y.device)
    x = y.new_zeros(y.shape[:-1] + (frame.N,))
    r = y
    for _ in range(rounds.iters):
        u = frame.apply_t(r)
        m = (rounds.eta * torch.linalg.vector_norm(r, dim=-1, keepdim=True)
             / root)
        u_hat = torch.clamp(u, -m, m)
        x = x + u_hat
        r = r - frame.apply(u_hat)
    return x + frame.apply_t(r)


# the frame's tensors ("[0]") bound: a graph per live frame, gone with it
_DEMOCRATIC = graph.Program(_democratic, bound=("[0]",))


def kashin_constant_upper(eta: float = DEFAULT_ETA,
                          delta: float = DEFAULT_DELTA) -> float:
    """K_u = η / ((1−η)√δ) for Parseval frames (paper Lemma 1)."""
    return eta / ((1.0 - eta) * delta ** 0.5)


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Which embedding to use inside a codec."""

    kind: str = "near_democratic"  # or "democratic"
    eta: float = DEFAULT_ETA
    delta: float = DEFAULT_DELTA
    iters: int = 30

    def embed(self, frame: Frame, y: torch.Tensor) -> torch.Tensor:
        if self.kind == "near_democratic":
            return near_democratic(frame, y)
        if self.kind == "democratic":
            return democratic(frame, y, self.eta, self.delta, self.iters)
        raise ValueError(f"unknown embedding kind {self.kind!r}")
