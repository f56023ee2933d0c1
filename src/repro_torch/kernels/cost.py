"""Bytes and operations of one call of each kernel, from its shapes.

The least work a call must do: each input read once, each output written
once, and the arithmetic of the transform, over coordinates (`coords`
values in `rows` rows of `n`). `chip_smoke.py` divides these counts by the
card's peaks (below) for each kernel's bound, and `repro_torch.obs.costs`
reports them for every `kernels.<op>.<path>` program a session observed,
so both read one definition. The dry-run's roofline
(`repro_torch.launch.hlo_analysis`) reads the same peaks.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data-sheet peaks: HBM3 bytes/s, dense f32 operations/s
# (TF32 off, as the port runs), NVLink 4 bytes/s per direction per card
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
NVLINK_BYTES_S = 450e9


def fwht(coords: int, n: int) -> tuple:
    """Read and write f32; log2 n add/sub levels and one scaling."""
    return coords * 8, coords * (math.log2(n) + 1)


def quantize_pack(coords: int, rows: int, bits: int) -> tuple:
    """Read x and the row scales, write the packed words."""
    return coords * (4 + bits / 8) + rows * 4, coords * 10


def unpack_dequant(coords: int, rows: int, bits: int) -> tuple:
    """Read the words and row scales, write f32 values."""
    return coords * (bits / 8 + 4) + rows * 4, coords * 4


def encode(coords: int, rows: int, n: int, bits: int, *,
           dither: bool = False, mask: bool = False) -> tuple:
    """Read u (and the dither, the row mask), write words and scales; the
    FWHT, the scale, the dither and the quantize."""
    nbytes = (coords * (4 + bits / 8) + rows * 4
              + (coords * 4 if dither else 0) + (rows * 4 if mask else 0))
    return nbytes, coords * ((math.log2(n) + 1) + 10)


def encode_ef(coords: int, rows: int, n: int, bits: int, *,
              dither: bool = False, mask: bool = False,
              residual_bytes: int = 4) -> tuple:
    """`encode`, plus the EF residual written; two FWHTs (the encode and
    the decode of its own payload), the quantize and the decode."""
    nbytes = (coords * (4 + bits / 8 + residual_bytes) + rows * 4
              + (coords * 4 if dither else 0) + (rows * 4 if mask else 0))
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


def program_cost(op: str, args, kwargs, static) -> tuple:
    """(bytes, operations) of one `kernels.<op>` call from its arguments'
    shapes and its static tag (("bits", b, ...), as `kernels.ops` records
    it). The attention's kv_len is data, which a shape cannot show: every
    cache position counts as visited."""
    st = dict(zip(static[::2], static[1::2])) if static else {}
    bits = st.get("bits")
    if op == "fwht":
        shape = args[0].shape
        return fwht(math.prod(shape), shape[-1])
    if op == "quantize_pack":
        shape = args[0].shape
        return quantize_pack(math.prod(shape), math.prod(shape[:-1]), bits)
    if op == "unpack_dequant":
        rows = math.prod(args[0].shape[:-1])
        return unpack_dequant(rows * st["n"], rows, bits)
    if op in ("encode", "encode_ef"):
        shape = args[0].shape
        kw = kwargs or {}
        flags = {"dither": kw.get("dither") is not None,
                 "mask": kw.get("mask") is not None}
        if op == "encode_ef":
            flags["residual_bytes"] = 2 if st.get("rdt") == "bfloat16" else 4
        fn = encode if op == "encode" else encode_ef
        return fn(math.prod(shape), math.prod(shape[:-1]), shape[-1], bits,
                  **flags)
    if op == "quant_decode_attention":
        b, k, g, dh = args[0].shape
        return quant_decode_attention(b, k, g, dh, bits,
                                      b * args[1].shape[1])
    raise ValueError(f"no cost model for kernel {op!r}")
