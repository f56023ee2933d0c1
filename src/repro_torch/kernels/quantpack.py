"""CUDA kernels: quantize + pack against a given scale, and unpack +
dequantize, of NDSC words (`csrc/quantpack.cu`).

Counterparts of `repro.kernels.quantpack.quantize_pack_pallas` and
`unpack_dequant_pallas`; bitwise equal to `ref.quantize_pack` and
`ref.unpack_dequant`. `quantize_pack` has no cap on N (the TPU kernel has
none either); N must be a multiple of 32/bits. Both stream their rows as
one flat sequence of float4s where wpr is a power of two (`pack_path`,
`unpack_path`), other rows row by row. The encoders from N = 2^16
(`quantencode.py`) run the same two kernels, quantize_pack with a dither
and a row mask, without counting their launches here.

Both wrappers take the FWHT's launch path (`kernels/fwht.py`): the ctypes
functions are cached, the device guard is entered only when the tensor is
not on the current card, and the output is the only allocation.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import (_check_cuda_f32, _stream, aligned,
                                      call_on)


def _check_bits(bits: int) -> None:
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"bits must be in {{1,2,4,8}}, got {bits}")


@functools.cache
def _unpack_flat():
    return _build.library("quantpack").ndsc_unpack_flat


@functools.cache
def _unpack_rows():
    return _build.library("quantpack").ndsc_unpack_rows


@functools.cache
def _quantize_pack():
    return _build.library("quantpack").ndsc_quantize_pack


def pack_path(n: int, bits: int) -> str:
    """"flat" where a row's wpr = N·bits/32 words is a power of two (every
    call of the port's paths): a float4 of x per thread, the row by a
    shift. "rows" otherwise (no dither or mask there)."""
    wpr = n * bits // 32
    return "flat" if wpr & (wpr - 1) == 0 else "rows"


def unpack_path(n: int, wpr: int, bits: int) -> str:
    """"flat" where rows are whole (n == wpr·32/bits) and wpr is a power of
    two (every call of the port's paths): the output is one stream, a
    float4 per thread. "rows" otherwise: trimmed rows, or a wpr whose row
    index would need a division."""
    whole = n == wpr * (32 // bits)
    return "flat" if whole and wpr & (wpr - 1) == 0 else "rows"


def unpack_dequant_cuda(words: torch.Tensor, scale: torch.Tensor, bits: int,
                        n: int) -> torch.Tensor:
    """words (..., W) int32, scale (..., 1) f32 → f32 (..., n)."""
    _check_bits(bits)
    if not (words.is_cuda and scale.is_cuda):
        raise ValueError("words and scale must be CUDA tensors")
    if words.dtype != torch.int32 or scale.dtype != torch.float32:
        raise ValueError(f"want int32 words and f32 scale, got {words.dtype} "
                         f"and {scale.dtype}")
    if not (words.is_contiguous() and scale.is_contiguous()):
        raise ValueError("words and scale must be contiguous")
    lead = tuple(words.shape[:-1])
    if tuple(scale.shape) != lead + (1,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != {lead + (1,)}")
    wpr = words.shape[-1]
    if not 0 < n <= wpr * (32 // bits):
        raise ValueError(f"n={n} does not fit {wpr} words of {bits}-bit codes")
    out = torch.empty(lead + (n,), dtype=torch.float32, device=words.device)
    rows = words.numel() // wpr
    if unpack_path(n, wpr, bits) == "flat":
        rc = call_on(words, _unpack_flat(), words.data_ptr(),
                     scale.data_ptr(), out.data_ptr(), rows, wpr, bits,
                     _stream(words))
    else:
        rc = call_on(words, _unpack_rows(), words.data_ptr(),
                     scale.data_ptr(), out.data_ptr(), rows, wpr, n, bits,
                     _stream(words))
    _build.check(rc, "unpack_dequant")
    unpack_dequant_cuda.launches += 1
    return out


def quantize_pack_cuda(x: torch.Tensor, scale: torch.Tensor,
                       bits: int) -> torch.Tensor:
    """x (..., N) f32, scale (..., 1) f32 → int32 words (..., N·bits/32)."""
    _check_bits(bits)
    _check_cuda_f32("x", x)
    _check_cuda_f32("scale", scale)
    n = x.shape[-1]
    k = 32 // bits
    if n < 1 or n % k:
        raise ValueError(f"N={n} is not a positive multiple of the packing "
                         f"factor {k}")
    lead = tuple(x.shape[:-1])
    if tuple(scale.shape) != lead + (1,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != {lead + (1,)}")
    words = torch.empty(lead + (n // k,), dtype=torch.int32, device=x.device)
    if pack_path(n, bits) == "flat":
        x = aligned(x)
    rc = call_on(x, _quantize_pack(), x.data_ptr(), scale.data_ptr(), None,
                 None, words.data_ptr(), None, x.numel() // n, n, bits,
                 _stream(x))
    _build.check(rc, "quantize_pack")
    quantize_pack_cuda.launches += 1
    return words


unpack_dequant_cuda.launches = 0
quantize_pack_cuda.launches = 0
