"""Bytes and operations of one call of each codec kernel, from its shapes,
and the card's peaks: the benchmark's frozen yardstick.

Copied from `src/repro_torch/kernels/cost.py` at commit 79e5167 (the
kernels' cost functions and the H100 peaks), so that a change to the
program cannot move the bounds its kernels are held to. Each input is
counted as read once and each output as written once; the operations are
those of the transform.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data-sheet peaks: HBM3 bytes/s, dense f32 operations/s
# (outside the tensor cores: TF32 off, as the configurations state)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a call: its bytes at the HBM rate or its
    operations at the f32 rate, whichever is longer."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S)


def fwht(coords: int, n: int) -> tuple:
    """Read and write f32; log2 n add/sub levels and one scaling."""
    return coords * 8, coords * (math.log2(n) + 1)


def quantize_pack(coords: int, rows: int, bits: int) -> tuple:
    """Read x and the row scales, write the packed words."""
    return coords * (4 + bits / 8) + rows * 4, coords * 10


def unpack_dequant(coords: int, rows: int, bits: int) -> tuple:
    """Read the words and row scales, write f32 values."""
    return coords * (bits / 8 + 4) + rows * 4, coords * 4


def encode(coords: int, rows: int, n: int, bits: int) -> tuple:
    """Read u, write words and scales; the FWHT, the scale and the
    quantize."""
    return coords * (4 + bits / 8) + rows * 4, coords * ((math.log2(n) + 1)
                                                         + 10)


def encode_ef(coords: int, rows: int, n: int, bits: int,
              residual_bytes: int = 4) -> tuple:
    """`encode`, plus the EF residual written; two FWHTs (the encode and
    the decode of its own payload), the quantize and the decode."""
    nbytes = coords * (4 + bits / 8 + residual_bytes) + rows * 4
    return nbytes, coords * (2 * (math.log2(n) + 1) + 12)


def quant_decode_attention(b: int, k: int, g: int, dh: int, bits: int,
                           visited: int) -> tuple:
    """Read the K and V words and scales of each visited (position, KV
    head) and q once, write the output; the two products over G rows and
    the unpack of K and V. `visited` is the positions read over the batch
    (the sum of kv_len)."""
    wpv = dh * bits // 32
    nbytes = visited * k * (4 * wpv + 4) * 2 + 2 * b * k * g * dh * 4
    flops = 4 * k * g * visited * dh + 2 * 4 * visited * k * dh
    return nbytes, flops
