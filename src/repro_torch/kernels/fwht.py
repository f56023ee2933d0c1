"""CUDA kernel: normalized fast Walsh–Hadamard transform (`csrc/fwht.cu`).

Counterpart of `repro.kernels.fwht.fwht_pallas`. The kernel keeps the
radix-2 butterfly order of `ref.fwht` and its single final multiply, so its
output is bitwise equal to the plain version. N is a power of 2 ≤ 8192
(`MAX_N`); larger N raises (not ported yet, see ROADMAP).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

MAX_N = 8192


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_cuda_f32(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fwht_cuda(x: torch.Tensor) -> torch.Tensor:
    """Normalized FWHT along the last axis of a contiguous f32 CUDA tensor."""
    _check_cuda_f32("x", x)
    n = x.shape[-1]
    if n & (n - 1) or n > MAX_N:
        raise ValueError(f"CUDA FWHT needs a power-of-2 N ≤ {MAX_N}, got {n}")
    y = torch.empty_like(x)
    rows = x.numel() // n if n else 0
    fn = _build.library("fwht").ndsc_fwht
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), rows, n,
                float(torch.tensor(1.0 / math.sqrt(n), dtype=torch.float32)),
                _stream(x))
    _build.check(rc, "fwht")
    fwht_cuda.launches += 1
    return y


fwht_cuda.launches = 0
