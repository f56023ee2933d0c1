"""CUDA kernel: unpack + dequantize of NDSC words (`csrc/quantpack.cu`).

Counterpart of `repro.kernels.quantpack.unpack_dequant_pallas`; bitwise
equal to `ref.unpack_dequant`. The encoder half of that module,
`quantize_pack_pallas`, has only its plain version here so far (ROADMAP,
queue 2 item 5): on a CUDA tensor `quantize_pack_cuda` raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import _stream


def unpack_dequant_cuda(words: torch.Tensor, scale: torch.Tensor, bits: int,
                        n: int) -> torch.Tensor:
    """words (..., W) int32, scale (..., 1) f32 → f32 (..., n)."""
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"bits must be in {{1,2,4,8}}, got {bits}")
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
    rows = words.numel() // wpr if wpr else 0
    fn = _build.library("quantpack")
    with torch.cuda.device(words.device):
        rc = fn(words.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, wpr,
                n, bits, _stream(words))
    _build.check(rc, "unpack_dequant")
    unpack_dequant_cuda.launches += 1
    return out


unpack_dequant_cuda.launches = 0


def quantize_pack_cuda(x: torch.Tensor, scale: torch.Tensor,
                       bits: int) -> torch.Tensor:
    raise NotImplementedError(
        "quantize_pack has no CUDA kernel yet (ROADMAP.md, queue 2 item 5: "
        "quantpack.py::quantize_pack_pallas); only its plain version on a "
        "CPU tensor exists")
