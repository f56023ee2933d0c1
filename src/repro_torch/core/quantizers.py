"""Scalar quantizers (paper §3, App. E); port of `repro.core.quantizers`.

  * uniform_quantize      — deterministic R-bit nearest-neighbour on B∞(1)
                            (Eq. (11); DSC/NDSC in DGD-DEF).
  * dithered_quantize     — unbiased stochastic uniform quantizer (App. E;
                            DQ-PSGD).
  * gain_quantize         — dithered magnitude quantizer on [0, B] (Eq. (20)).
  * subsample_mask        — the sub-linear budget (R < 1): a Bernoulli
                            keep-mask (App. E.2).

Each step is rounded on its own in float32, as the eager reference rounds
it, so indices and values are bitwise equal to eager `repro` given the same
key. Divisors are float32 tensors on the operand's device: PyTorch on CUDA
runs `t / python_float` as a multiply by the reciprocal, which is not the
correctly rounded quotient. (Under `jit`, XLA does the same to the
reference, which is why the contract is with the eager reference.)
"""
from __future__ import annotations

import torch

from repro_torch import random as rnd


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """v as a float32 tensor on like's device (a tensor v passes through).
    A number is written by a fill kernel, no copy from the host, so a
    captured step program can hold it (`repro_torch.graph`)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=torch.float32, device=like.device)
    return torch.full((), v, dtype=torch.float32, device=like.device)


def levels_for_budget(bits_per_dim: float) -> int:
    """Number of uniform levels affordable with `bits_per_dim` bits (≥ 2)."""
    return max(2, int(2.0 ** bits_per_dim))


def _uniform_index(x: torch.Tensor, levels: int) -> torch.Tensor:
    delta = _f32(2.0 / levels, x)
    return torch.clamp(torch.floor((torch.clamp(x, -1.0, 1.0) + 1.0) / delta),
                       0, levels - 1)


def dequantize_indices(idx: torch.Tensor, levels: int,
                       dtype=torch.float32) -> torch.Tensor:
    """v_i = −1 + (2i + 1)Δ/2, Δ = 2/levels."""
    idx = idx.to(dtype)
    return -1.0 + (2.0 * idx + 1.0) * _f32(2.0 / levels, idx) / 2.0


def uniform_quantize(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Deterministic nearest-neighbour uniform quantizer on [−1, 1]; max
    per-coordinate error Δ/2."""
    return dequantize_indices(_uniform_index(x, levels), levels, x.dtype)


def quantize_indices(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Integer codewords of the deterministic uniform quantizer (the wire)."""
    return _uniform_index(x, levels).to(torch.int32)


def _delta(lo, hi, levels: int, x: torch.Tensor) -> torch.Tensor:
    """(hi − lo)/(levels − 1): in double for float bounds, rounded once to
    f32 (as a weakly typed constant); in f32 for tensor bounds."""
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        return (_f32(hi, x) - _f32(lo, x)) / _f32(levels - 1, x)
    return _f32((hi - lo) / (levels - 1), x)


def _dithered_index(key, x, levels, lo, hi) -> torch.Tensor:
    delta = _delta(lo, hi, levels, x)
    lo_t, hi_t = _f32(lo, x), _f32(hi, x)
    pos = (torch.clamp(x, lo_t, hi_t) - lo_t) / delta
    base = torch.floor(pos)
    up = rnd.uniform(key, x.shape) < pos - base
    return torch.clamp(base + up.to(base.dtype), 0, levels - 1)


def dithered_quantize(key: torch.Tensor, x: torch.Tensor, levels: int,
                      lo=-1.0, hi=1.0) -> torch.Tensor:
    """Unbiased stochastic uniform quantizer on [lo, hi] (paper Eq. (20)):
    v ∈ [u_j, u_{j+1}) goes to u_{j+1} w.p. (v − u_j)/Δ, else to u_j."""
    idx = _dithered_index(key, x, levels, lo, hi)
    return _f32(lo, x) + idx * _delta(lo, hi, levels, x)


def dithered_quantize_indices(key: torch.Tensor, x: torch.Tensor,
                              levels: int, lo=-1.0, hi=1.0) -> torch.Tensor:
    """Integer codewords of the dithered quantizer."""
    return _dithered_index(key, x, levels, lo, hi).to(torch.int32)


def dithered_dequantize_indices(idx: torch.Tensor, levels: int, lo=-1.0,
                                hi=1.0, dtype=torch.float32) -> torch.Tensor:
    idx = idx.to(dtype)
    return _f32(lo, idx) + idx * _delta(lo, hi, levels, idx)


def gain_quantize(key: torch.Tensor, v: torch.Tensor, dynamic_range,
                  bits: int = 32) -> torch.Tensor:
    """Dithered magnitude quantizer Q_G on [0, B] (paper Eq. (20)); unbiased.
    At 32 bits levels = 2^31, and the clip to levels − 1 rounds to 2^31 in
    f32 as it does in the reference."""
    levels = min(2 ** bits, 2 ** 31)
    return dithered_quantize(key, v, levels, lo=0.0, hi=dynamic_range)


def subsample_mask(key: torch.Tensor, shape, keep_fraction: float
                   ) -> torch.Tensor:
    """Bernoulli keep-mask for the sub-linear regime (App. E.2): E[mask] =
    keep_fraction, so dividing kept values by it is unbiased."""
    u = rnd.uniform(key, shape)
    return (u < _f32(keep_fraction, u)).to(torch.float32)
