"""CUDA kernel: the fused NDSC encoder (`csrc/quantencode.cu`).

Counterpart of `repro.kernels.quantencode.encode_pallas` and
`encode_ef_pallas`: sign flip → FWHT → ℓ∞ scale → (dither) → quantize →
int32 pack → (row mask), and for `encode_ef` the in-tile decode of its own
payload and the residual u − D(E(u)). Both wrappers launch the same CUDA
kernel; each keeps its own launch count. The payload (words, scale) is
bitwise equal to `ref.encode`; the residual to `ref.encode_ef` as well,
since every float step is a round-to-nearest intrinsic.

The dither and the keep mask are drawn outside the kernel (in
`dist.gradcomp`) and passed in, so a kernel can never change a payload.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import (MAX_N, _check_cuda_f32, _stream,
                                      aligned, call_on, f32, inv_sqrt)

MIN_N = 32


def _ptr(t):
    """Device pointer of an optional tensor (None → a null pointer)."""
    return None if t is None else t.data_ptr()


@functools.cache
def _kernel():
    return _build.library("quantencode").ndsc_encode


def _launch(chunks, signs, bits, dither, mask, rescale, residual_dtype,
            ef: bool):
    _check_cuda_f32("chunks", chunks)
    _check_cuda_f32("signs", signs)
    n = chunks.shape[-1]
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"bits must be in {{1,2,4,8}}, got {bits}")
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise ValueError(
            f"CUDA encode needs a power-of-2 N in [{MIN_N}, {MAX_N}], got {n}")
    if tuple(signs.shape) != (n,):
        raise ValueError(f"signs shape {tuple(signs.shape)} != ({n},)")
    lead = tuple(chunks.shape[:-1])
    if dither is not None:
        _check_cuda_f32("dither", dither)
        if dither.shape != chunks.shape:
            raise ValueError("dither must have the shape of chunks")
    if mask is not None:
        _check_cuda_f32("mask", mask)
        if tuple(mask.shape) != lead + (1,):
            raise ValueError(f"mask shape {tuple(mask.shape)} != {lead + (1,)}")
    if residual_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"residual_dtype must be float32 or bfloat16, got "
                         f"{residual_dtype}")
    chunks, signs = aligned(chunks), aligned(signs)
    if dither is not None:
        dither = aligned(dither)
    dev = chunks.device
    words = torch.empty(lead + (n * bits // 32,), dtype=torch.int32,
                        device=dev)
    scale = torch.empty(lead + (1,), dtype=torch.float32, device=dev)
    resid = torch.empty_like(chunks) if ef else None
    rows = chunks.numel() // n
    rc = call_on(chunks, _kernel(), chunks.data_ptr(), signs.data_ptr(),
                 _ptr(dither), _ptr(mask), words.data_ptr(), scale.data_ptr(),
                 _ptr(resid), rows, n, bits, inv_sqrt(n),
                 int(rescale is not None), f32(rescale or 1.0),
                 int(residual_dtype == torch.bfloat16), _stream(chunks))
    _build.check(rc, "encode_ef" if ef else "encode")
    return words, scale, resid


def encode_cuda(chunks: torch.Tensor, signs: torch.Tensor, bits: int, *,
                dither: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> tuple:
    """Fused encode. Returns (words int32 (..., N·R/32), scale f32 (..., 1))."""
    words, scale, _ = _launch(chunks, signs, bits, dither, mask, None,
                              torch.float32, ef=False)
    encode_cuda.launches += 1
    return words, scale


def encode_ef_cuda(chunks: torch.Tensor, signs: torch.Tensor, bits: int, *,
                   dither: torch.Tensor | None = None,
                   mask: torch.Tensor | None = None,
                   rescale: float | None = None,
                   residual_dtype=torch.float32) -> tuple:
    """Fused encode + EF residual. Returns (words, scale, residual f32)."""
    out = _launch(chunks, signs, bits, dither, mask, rescale, residual_dtype,
                  ef=True)
    encode_ef_cuda.launches += 1
    return out


encode_cuda.launches = 0
encode_ef_cuda.launches = 0
