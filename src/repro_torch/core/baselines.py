"""Baseline compressors the paper compares against (Table 1, §5); port of
`repro.core.baselines`.

Each is a `(key, y) -> y_hat` roundtrip plus a bit audit. Rows are
independent, so a batch of rows (with a stack of keys, one per row) goes
through in one call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch import random as rnd
from repro_torch.core import quantizers as q
from repro_torch.kernels.ref import TINY


@dataclasses.dataclass(frozen=True)
class Compressor:
    name: str
    roundtrip: Callable  # (key, y) -> y_hat
    wire_bits: Callable  # (n) -> float  (scalars such as norms ride at 32 b)


def _linf(y: torch.Tensor):
    """(‖y‖∞ per row, max(‖y‖∞, tiny))."""
    scale = torch.amax(torch.abs(y), dim=-1, keepdim=True)
    return scale, torch.clamp(scale, min=TINY)


def naive_uniform(levels: int) -> Compressor:
    """The paper's naive / DQGD scalar quantizer with an ‖·‖∞ scale."""
    def fn(key, y):
        scale, safe = _linf(y)
        return q.uniform_quantize(y / safe, levels) * scale

    return Compressor(f"naive-uniform({levels}l)", fn,
                      lambda n: n * math.log2(levels) + 32)


def standard_dither(levels: int) -> Compressor:
    """Standard dithering (SD [8]) with an ‖·‖∞ dynamic range."""
    def fn(key, y):
        scale, safe = _linf(y)
        return q.dithered_quantize(key, y / safe, levels) * scale

    return Compressor(f"standard-dither({levels}l)", fn,
                      lambda n: n * math.log2(levels) + 32)


def qsgd(s: int) -> Compressor:
    """QSGD [8]: s stochastic levels on |y_i|/‖y‖₂ ∈ [0, 1], sign apart."""
    def fn(key, y):
        norm = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
        level = torch.abs(y) / torch.clamp(norm, min=TINY) * s
        lo = torch.floor(level)
        up = rnd.uniform(key, y.shape) < (level - lo)
        s_t = torch.full((), float(s), dtype=y.dtype, device=y.device)
        zeta = (lo + up.to(y.dtype)) / s_t
        return torch.sign(y) * zeta * norm

    return Compressor(f"qsgd(s={s})", fn,
                      lambda n: n * (1 + math.log2(s + 1)) + 32)


def sign_compressor(scaled: bool = True) -> Compressor:
    """signSGD [14, 15] with an ℓ1 scale (EF-SignSGD)."""
    def fn(key, y):
        if not scaled:
            return torch.sign(y)
        return torch.sign(y) * torch.mean(torch.abs(y), dim=-1, keepdim=True)

    return Compressor("sign" + ("-l1" if scaled else ""), fn, lambda n: n + 32)


def ternary() -> Compressor:
    """TernGrad [16]: levels {−1, 0, +1}, stochastic, ‖·‖∞ scale."""
    def fn(key, y):
        scale, safe = _linf(y)
        keep = rnd.uniform(key, y.shape) < torch.abs(y) / safe
        return torch.sign(y) * keep.to(y.dtype) * scale

    return Compressor("ternary", fn, lambda n: n * math.log2(3) + 32)


def _quantize_kept(kept, mask, levels):
    scale, safe = _linf(kept)
    return q.uniform_quantize(kept / safe, levels) * scale * mask


def _sparse_bits(k_fraction, quant_levels):
    def bits(n):
        k = max(1, int(round(k_fraction * n)))
        payload = 32 if quant_levels is None else math.log2(quant_levels)
        return k * payload + math.log2(math.comb(n, k)) + 32
    return bits


def topk(k_fraction: float, quant_levels: Optional[int] = None) -> Compressor:
    """Keep the top round(k·n) coordinates by magnitude (ties at the
    threshold all kept); optionally quantize them [18]."""
    def fn(key, y):
        k = max(1, int(round(k_fraction * y.shape[-1])))
        a = torch.abs(y)
        thresh = torch.sort(a, dim=-1, descending=True).values[..., k - 1:k]
        mask = (a >= thresh).to(y.dtype)
        kept = y * mask
        if quant_levels is None:
            return kept
        return _quantize_kept(kept, mask, quant_levels)

    tag = f"top{int(k_fraction * 100)}%" + (
        f"+{quant_levels}l" if quant_levels else "")
    return Compressor(tag, fn, _sparse_bits(k_fraction, quant_levels))


def randk(k_fraction: float, quant_levels: Optional[int] = None,
          unbiased: bool = False) -> Compressor:
    """Random-k [19]: exactly k = round(k·n) survivors per row, those whose
    uniform draw is at most the k-th smallest."""
    def fn(key, y):
        km, _ = rnd.split2(key)
        n = y.shape[-1]
        k = max(1, int(round(k_fraction * n)))
        draw = rnd.uniform(km, y.shape)
        thresh = torch.sort(draw, dim=-1).values[..., k - 1:k]
        mask = (draw <= thresh).to(y.dtype)
        kept = y * mask
        if quant_levels is not None:
            kept = _quantize_kept(kept, mask, quant_levels)
        if unbiased:
            # each coordinate survives w.p. exactly k/n under the exact-k mask
            kept = kept * (n / k)
        return kept

    tag = f"rand{int(k_fraction * 100)}%" + (
        f"+{quant_levels}l" if quant_levels else "")
    return Compressor(tag, fn, _sparse_bits(k_fraction, quant_levels))


def normalized_error(key: torch.Tensor, comp: Compressor,
                     y: torch.Tensor) -> torch.Tensor:
    """‖C(y) − y‖₂ / ‖y‖₂ per row — the metric of paper Fig. 1a / Table 1."""
    y_hat = comp.roundtrip(key, y)
    return (torch.linalg.vector_norm(y_hat - y, dim=-1)
            / torch.linalg.vector_norm(y, dim=-1))
