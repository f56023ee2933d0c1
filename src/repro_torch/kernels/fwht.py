"""CUDA kernel: normalized fast Walsh–Hadamard transform (`csrc/fwht.cu`).

Counterpart of `repro.kernels.fwht.fwht_pallas`. The kernel keeps the
radix-2 butterfly order of `ref.fwht` and its single final multiply, so its
output is bitwise equal to the plain version. N is a power of 2 ≤ 8192
(`MAX_N`); larger N raises (not ported yet, see ROADMAP).

The serve path calls it on a few hundred rows at a time, where the host's
work per call is most of its time, so the launch path keeps that work
small: the f32 constants and the ctypes function are cached, the device
guard is entered only when the tensor is not on the current card, and the
stream handle is read without building a `torch.cuda.Stream`.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_N = 8192


def f32(v: float) -> float:
    """v rounded to float32, as the Python float the kernels receive."""
    return float(np.float32(v))


@functools.cache
def inv_sqrt(n: int) -> float:
    """f32(1/√n), the FWHT's final scaling factor."""
    return f32(1.0 / math.sqrt(n))


def _stream(x: torch.Tensor) -> int:
    """Raw handle of the current stream on x's card (the call
    `torch._dynamo`'s `get_raw_stream` makes)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def call_on(x: torch.Tensor, fn, *args) -> int:
    """fn(*args) with x's card current, entering a device guard only when
    it is not current already."""
    if x.device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(x.device):
        return fn(*args)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 16-byte aligned (the
    warp-resident kernels move float4s)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_cuda_f32(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.cache
def _kernel():
    return _build.library("fwht").ndsc_fwht


def fwht_cuda(x: torch.Tensor) -> torch.Tensor:
    """Normalized FWHT along the last axis of a contiguous f32 CUDA tensor."""
    _check_cuda_f32("x", x)
    n = x.shape[-1]
    if n & (n - 1) or n > MAX_N:
        raise ValueError(f"CUDA FWHT needs a power-of-2 N ≤ {MAX_N}, got {n}")
    x = aligned(x)
    y = torch.empty_like(x)
    rows = x.numel() // n if n else 0
    rc = call_on(x, _kernel(), x.data_ptr(), y.data_ptr(), rows, n,
                 inv_sqrt(n), _stream(x))
    _build.check(rc, "fwht")
    fwht_cuda.launches += 1
    return y


fwht_cuda.launches = 0
