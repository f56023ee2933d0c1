"""CUDA kernels: the NDSC encoder (`csrc/quantencode.cu`, and above
`CLUSTER_MAX_N` a sequence of passes).

Counterpart of `repro.kernels.quantencode.encode_pallas` and
`encode_ef_pallas`: sign flip → FWHT → ℓ∞ scale → (dither) → quantize →
int32 pack → (row mask), and for `encode_ef` the decode of its own payload
and the residual u − D(E(u)). `encode_path` picks one of four routes by N:
- "fused", 32 ≤ N ≤ 8192: the warp-resident kernel (N ≤ 1024) or the
  shared-memory one of `quantencode.cu`, one launch;
- "row", N = 2^14 and 2^15: `encode_row_kernel`, one launch, persistent
  blocks over rows with 32 values a thread in registers and shared memory
  only for the loads and the exchanges between a load layout and a
  strided one (the header of `quantencode.cu` has the design and its
  register and shared-memory budget per N; the schedule is
  `csrc/row_fwht.cuh`, shared with the FWHT's row kernel);
- "cluster", 2^16 ≤ N ≤ `CLUSTER_MAX_N` = 2^17: `encode_cluster_kernel`,
  one launch. A row is held by a thread-block cluster of C = N / 2^14
  CTAs (4 or 8, within the portable cluster size of 8), each CTA a
  segment of 2^14 in the row kernel's registers and schedule (512
  threads, 64 registers, 96 KB of shared memory, two CTAs an SM). The
  top log2(C) stages follow one exchange through distributed shared
  memory that transposes the row: CTA r then holds piece r (2^14 / C
  positions) of every segment, runs the stages over the segments in
  registers, and quantizes, packs and writes those pieces; the row
  maximum is the maximum of the CTAs' maxima, read the same way. The EF
  inverse reads its own segment's words back and runs the same schedule.
  Persistent clusters stride over rows (as many as
  `cudaOccupancyMaxActiveClusters` fits);
- "passes", N > 2^17: the FWHT's passes (`fwht.run_passes`) with the signs
  folded into the first one's loads and the row maximum into the last
  one's stores, then the flat quantize_pack kernel with the dither and
  the mask, and for `encode_ef` the flat unpack_dequant kernel and the
  FWHT's passes again with the mask and rescale folded into the first
  loads and the signs, the `residual_dtype` rounding and the subtract
  into the last stores.
The route follows from the shape alone: a launch that fails raises, and
no other route is tried. Each wrapper counts one launch per call under
its own name. The payload (words, scale) is bitwise equal to
`ref.encode`; the residual to `ref.encode_ef` as well, since every float
step is a round-to-nearest intrinsic.

The dither and the keep mask are drawn outside the kernel (in
`dist.gradcomp`) and passed in, so a kernel can never change a payload.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import (ROW_MAX_N, SINGLE_MAX_N,
                                      _check_cuda_f32, _ptr, _stream,
                                      aligned, call_on, f32, inv_sqrt,
                                      run_passes)
from repro_torch.kernels.quantpack import _quantize_pack, _unpack_flat

MIN_N = 32
# the largest N of the "cluster" route (quantencode.cu kClusterMaxN): a
# cluster of 8 CTAs of 2^14, the portable cluster size; 2^18 would need
# 16-CTA clusters (non-portable), whose fit chip_smoke.py phase 1 prints
CLUSTER_MAX_N = 1 << 17


def encode_path(n: int) -> str:
    """"fused" for 32 ≤ N ≤ 8192, "row" for 2^14 and 2^15, "cluster" for
    2^16 ≤ N ≤ CLUSTER_MAX_N (each one kernel of quantencode.cu), "passes"
    above; N must be a power of two."""
    if n & (n - 1) or n < MIN_N:
        raise ValueError(
            f"CUDA encode needs a power-of-2 N ≥ {MIN_N}, got {n}")
    if n <= SINGLE_MAX_N:
        return "fused"
    if n <= ROW_MAX_N:
        return "row"
    return "cluster" if n <= CLUSTER_MAX_N else "passes"


def cluster_fit(cluster: int) -> int:
    """The clusters of `cluster` CTAs of the "cluster" route's kernel (its
    threads and shared memory) that fit on the current card at once
    (`cudaOccupancyMaxActiveClusters`; above 8 CTAs with the non-portable
    opt-in). Raises where the query fails."""
    out = ctypes.c_int(0)
    rc = _build.library("quantencode").ndsc_encode_cluster_fit(
        cluster, ctypes.byref(out))
    _build.check(rc, f"cluster fit of {cluster} CTAs")
    return out.value


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
    path = encode_path(n)
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
    bf16 = residual_dtype == torch.bfloat16
    if path == "passes":
        if rows:
            call_on(chunks, _passes, chunks, signs, bits, dither, mask,
                    rescale, bf16, words, scale, resid)
        return words, scale, resid
    rc = call_on(chunks, _kernel(), chunks.data_ptr(), signs.data_ptr(),
                 _ptr(dither), _ptr(mask), words.data_ptr(), scale.data_ptr(),
                 _ptr(resid), rows, n, bits, inv_sqrt(n),
                 int(rescale is not None), f32(rescale or 1.0), int(bf16),
                 _stream(chunks))
    _build.check(rc, "encode_ef" if ef else "encode")
    return words, scale, resid


def _passes(chunks, signs, bits, dither, mask, rescale, bf16: bool, words,
            scale, resid) -> None:
    """The encoder from N = 2^16 into words, scale (and resid). Scratch:
    the embedded rows e (reused for the EF decode) and the unmasked row
    maxima."""
    n = chunks.shape[-1]
    rows = chunks.numel() // n
    e = torch.empty_like(chunks)
    rowmax = torch.empty(rows, dtype=torch.float32, device=chunks.device)
    stream = _stream(chunks)
    run_passes(chunks, e, e, signs_in=signs, rowmax=rowmax)
    rc = _quantize_pack()(e.data_ptr(), rowmax.data_ptr(), _ptr(dither),
                          _ptr(mask), words.data_ptr(), scale.data_ptr(),
                          rows, n, bits, stream)
    _build.check(rc, "encode: quantize pass")
    if resid is None:
        return
    rc = _unpack_flat()(words.data_ptr(), scale.data_ptr(), e.data_ptr(),
                        rows, words.shape[-1], bits, stream)
    _build.check(rc, "encode_ef: unpack pass")
    run_passes(e, e, resid, row_mul=mask,
               rescale=rescale if mask is not None else None,
               signs_out=signs, sub_from=chunks, round_bf16=bf16)


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
