"""CUDA kernel: normalized fast Walsh–Hadamard transform (`csrc/fwht.cu`).

Counterpart of `repro.kernels.fwht.fwht_pallas`. The kernel keeps the
radix-2 butterfly order of `ref.fwht` and its single final multiply, so its
output is bitwise equal to the plain version, for every power of two N.
`fwht_path` picks one of three routes by N: "single" up to `SINGLE_MAX_N`
= 8192 (one launch of the warp-resident or shared-memory kernel); "row"
at 2^14 and 2^15 (one launch of `fwht_row_kernel`: 32 values a thread in
registers, shared memory only to change layout and to stage the next
row); "passes" from 2^16, as `fwht_plan` lays them out (the row kernel on
contiguous segments of 2^15, then `fwht_cols_kernel` passes of at most 8
stages, again register-resident). `run_passes` launches the last two. The
encoders from N = 2^16 (`quantencode.py`, route "passes") run the same
passes with their own per-value steps folded in; at 2^14 and 2^15 they
run one kernel of their own.

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

# the largest N of the single-launch kernels; above it the passes run
SINGLE_MAX_N = 8192
# the largest N of the "row" route (one pass of fwht_row_kernel)
ROW_MAX_N = 1 << 15
# the first pass runs the stages h < 2^15 on contiguous segments of 2^15
FIRST_PASS_STAGES = 15
# a later pass's tile holds 2^13 values: 2^k strided rows by W = 2^(13-k)
# contiguous columns; at most 8 stages keep W >= 32 floats (128 B lines)
TILE_LOG2 = 13
MAX_PASS_STAGES = 8


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


def fwht_plan(log2n: int) -> list:
    """The passes of the FWHT of N = 2^log2n (N ≥ 2^14) as (first stage,
    stages): the stages h = 2^s for s in [first, first + stages), in
    increasing order. The first pass takes up to 15 stages; the rest are
    split as evenly as possible into passes of at most 8 (2^28: 15, 7,
    6)."""
    first = min(log2n, FIRST_PASS_STAGES)
    plan = [(0, first)]
    rest = log2n - first
    if rest:
        n_pass = -(-rest // MAX_PASS_STAGES)
        base, extra = divmod(rest, n_pass)
        s = first
        for i in range(n_pass):
            k = base + (i < extra)
            plan.append((s, k))
            s += k
    return plan


def pass_cols(first: int, stages: int) -> int:
    """log2 of a pass's tile width W: 0 in the first pass (its segments
    are contiguous), else 13 − stages (a tile of 2^13 values), within the
    2^first contiguous values a stage-`first` pair spans."""
    return 0 if first == 0 else TILE_LOG2 - stages


def fwht_path(n: int) -> str:
    """"single" (one launch of the whole transform) for N ≤ 8192, "row"
    (one launch of the row kernel) for 2^14 and 2^15, "passes" above; N
    must be a power of two."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"CUDA FWHT needs a power-of-2 N, got {n}")
    if n <= SINGLE_MAX_N:
        return "single"
    return "row" if n <= ROW_MAX_N else "passes"


def _ptr(t):
    """Device pointer of an optional tensor (None → a null pointer)."""
    return None if t is None else t.data_ptr()


@functools.cache
def _kernel():
    return _build.library("fwht").ndsc_fwht


@functools.cache
def _pass_kernel():
    return _build.library("fwht").ndsc_fwht_pass


def run_passes(src: torch.Tensor, work: torch.Tensor, out: torch.Tensor, *,
               signs_in=None, row_mul=None, rescale=None, signs_out=None,
               sub_from=None, rowmax=None, round_bf16: bool = False) -> None:
    """The FWHT of src's rows (N > 8192) by `fwht_plan`'s passes (one at
    2^14 and 2^15): the first reads src, the middle ones run in place on
    `work`, the last writes `out` (work and out may be one tensor).
    Folded in: at the first pass's loads × signs_in, × row_mul[row],
    ÷ rescale; at the last pass's stores the row maximum of |y| into
    rowmax, × signs_out, the bf16 rounding and sub_from − y. All tensors are contiguous f32 on one card, the
    (rows, N) ones and the signs 16-byte aligned; no launch is counted."""
    n = src.shape[-1]
    rows = src.numel() // n
    log2n = n.bit_length() - 1
    plan = fwht_plan(log2n)
    fn, stream = _pass_kernel(), _stream(src)
    for i, (first, stages) in enumerate(plan):
        head, last = i == 0, i == len(plan) - 1
        rc = fn(src.data_ptr() if head else work.data_ptr(),
                out.data_ptr() if last else work.data_ptr(),
                _ptr(signs_in) if head else None,
                _ptr(row_mul) if head else None,
                int(head and rescale is not None), f32(rescale or 1.0),
                _ptr(signs_out) if last else None,
                _ptr(sub_from) if last else None,
                _ptr(rowmax) if last else None, int(last and round_bf16),
                rows, log2n, first, stages, pass_cols(first, stages),
                int(last), inv_sqrt(n), stream)
        _build.check(rc, f"fwht pass {i}")


def fwht_cuda(x: torch.Tensor) -> torch.Tensor:
    """Normalized FWHT along the last axis of a contiguous f32 CUDA tensor:
    one launch up to N = 2^15, `fwht_plan`'s passes above (counted as one
    launch either way)."""
    _check_cuda_f32("x", x)
    n = x.shape[-1]
    path = fwht_path(n)
    x = aligned(x)
    y = torch.empty_like(x)
    if path == "single":
        rc = call_on(x, _kernel(), x.data_ptr(), y.data_ptr(),
                     x.numel() // n, n, inv_sqrt(n), _stream(x))
        _build.check(rc, "fwht")
    elif x.numel():
        call_on(x, run_passes, x, y, y)
    fwht_cuda.launches += 1
    return y


fwht_cuda.launches = 0
