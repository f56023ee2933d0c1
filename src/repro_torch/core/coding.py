"""Democratic (DSC) and Near-Democratic (NDSC) Source Coding (paper §3);
port of `repro.core.coding`.

E(y) = Q(x / ‖x‖∞),   D(x') = ‖x‖∞ · S x',

x the (near-)democratic embedding of y in frame S. A budget of R bits per
ORIGINAL dimension gives the N = λn embedded dimensions R/λ bits each; the
scale ‖x‖∞ rides along in f32. Deterministic (nearest-neighbour) mode is
DGD-DEF's, dithered (unbiased) mode DQ-PSGD's; below 1 bit per embedded
dimension the sub-linear path keeps a Bernoulli subset at 1 bit each.

`Payload` is the wire. Given the key it is bitwise the eager reference's
for a Hadamard frame: the key split order is part of it. The codec is
row-wise (per-row scales), so a batch of rows encodes in one call, each row
under its own key when `key` is a stack of keys (m, 2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch import random as rnd
from repro_torch.core import quantizers as q
from repro_torch.core.embeddings import EmbeddingSpec, kashin_constant_upper
from repro_torch.core.frames import Frame
from repro_torch.kernels.ref import TINY


class Payload(NamedTuple):
    """What crosses the wire."""

    indices: torch.Tensor           # int32 codewords, (..., N)
    scale: torch.Tensor             # f32, (..., 1): ‖x‖∞
    mask: Optional[torch.Tensor]    # f32 0/1 keep-mask (sub-linear) or None


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    bits_per_dim: float = 4.0            # R, per ORIGINAL dimension
    dithered: bool = False               # False: DGD-DEF; True: DQ-PSGD
    unbiased_rescale: bool = True        # sub-linear path: divide by keep rate
    embedding: EmbeddingSpec = EmbeddingSpec()


class Codec:
    """(E, D) pair bound to a frame."""

    def __init__(self, frame: Frame, config: CodecConfig):
        self.frame = frame
        self.config = config
        self.n = frame.n
        self.N = frame.N
        self.aspect_ratio = frame.N / frame.n
        self.embedded_bits = config.bits_per_dim / self.aspect_ratio
        self.sublinear = self.embedded_bits < 1.0
        if self.sublinear:
            self.levels = 2
            self.keep_fraction = float(self.embedded_bits)
        else:
            self.levels = q.levels_for_budget(self.embedded_bits)
            self.keep_fraction = 1.0

    def wire_bits(self) -> float:
        """Expected bits on the wire per encoded vector (excl. the scale)."""
        if self.sublinear:
            return self.N * self.keep_fraction * 1.0
        return self.N * math.log2(self.levels)

    def encode(self, y: torch.Tensor,
               key: Optional[torch.Tensor] = None) -> Payload:
        x = self.config.embedding.embed(self.frame, y)
        scale = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        xn = x / torch.clamp(scale, min=TINY)
        if not self.config.dithered:
            if self.sublinear:
                _, km = rnd.split2(_require(key))
                mask = q.subsample_mask(km, x.shape, self.keep_fraction)
                return Payload(q.quantize_indices(xn, 2), scale, mask)
            return Payload(q.quantize_indices(xn, self.levels), scale, None)
        kq, km = rnd.split2(_require(key))
        if self.sublinear:
            mask = q.subsample_mask(km, x.shape, self.keep_fraction)
            return Payload(q.dithered_quantize_indices(kq, xn, 2), scale, mask)
        return Payload(q.dithered_quantize_indices(kq, xn, self.levels),
                       scale, None)

    def decode(self, payload: Payload) -> torch.Tensor:
        idx, scale, mask = payload
        levels = 2 if self.sublinear else self.levels
        if self.config.dithered:
            xn = q.dithered_dequantize_indices(idx, levels)
        else:
            xn = q.dequantize_indices(idx, levels)
        if mask is not None:
            xn = xn * mask
            # 1/keep rescale restores unbiasedness on the dithered path only:
            # the deterministic path relies on error feedback and a
            # contractive map, and rescaling would inflate β past 1.
            if self.config.unbiased_rescale and self.config.dithered:
                xn = xn / torch.full((), self.keep_fraction,
                                     dtype=xn.dtype, device=xn.device)
        return self.frame.apply(xn * scale)

    def roundtrip(self, y: torch.Tensor,
                  key: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decode(self.encode(y, key))

    def error_bound(self) -> float:
        """Thm. 1 contraction β: ‖y − Q(y)‖₂ ≤ β‖y‖₂ (w.h.p.)."""
        r_over_lambda = self.config.bits_per_dim / self.aspect_ratio
        if self.config.embedding.kind == "democratic":
            ku = kashin_constant_upper(self.config.embedding.eta,
                                       self.config.embedding.delta)
            return 2.0 ** (1.0 - r_over_lambda) * ku
        return 2.0 ** (2.0 - r_over_lambda) * math.sqrt(math.log(2 * self.N))


def _require(key: Optional[torch.Tensor]) -> torch.Tensor:
    if key is None:
        raise ValueError("this codec mode is randomized: a PRNG key is required")
    return key


def compress_in_embedded_space(frame: Frame, compressor, y: torch.Tensor,
                               key: Optional[torch.Tensor] = None,
                               embedding: EmbeddingSpec = EmbeddingSpec()
                               ) -> torch.Tensor:
    """E(y) = C(x), D = S· — inherits the dimension-free error (Thm. 4).
    `compressor(key, x) -> x_hat` is any compression map."""
    x = embedding.embed(frame, y)
    return frame.apply(compressor(key, x))
