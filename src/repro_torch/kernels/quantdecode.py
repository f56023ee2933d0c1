"""CUDA kernel: fused dequantize + flash-decode GQA attention over the
NDSC-packed KV cache (`csrc/quantdecode.cu`).

Counterpart of `repro.kernels.quantdecode.quant_decode_attention_pallas`,
held to `ref.quant_decode_attention` within rtol = atol = 2e-4, the bound
the JAX package holds its Pallas kernel to; not bitwise, since the
exponentials and sums run in another order. Unlike the TPU kernel there is
no `block_c`: any cache length C >= 1 works, and the tile length is chosen
here from dh so the block's shared memory stays small.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import MAX_N, _check_cuda_f32, _stream

TILE_FLOATS = 8192            # dequantized K (or V) floats per tile
MAX_TILE = 64                 # positions per tile
MAX_SMEM_BYTES = 232448       # an H100 block's dynamic shared memory


def tile_len(dh: int) -> int:
    """Cache positions per tile: 64, fewer when dh > 128."""
    return max(1, min(MAX_TILE, TILE_FLOATS // dh))


def smem_bytes(g: int, dh: int, tc: int) -> int:
    """Shared memory of one block: q and acc (g·dh each), the K tile with
    a padded row (tc·(dh+4)), the V tile (tc·dh), the probabilities (g·tc)
    and three running values per row."""
    return 4 * (2 * g * dh + tc * (2 * dh + 4) + g * tc + 3 * g)


def quant_decode_attention_cuda(q: torch.Tensor, kw: torch.Tensor,
                                ks: torch.Tensor, vw: torch.Tensor,
                                vs: torch.Tensor, kv_len: torch.Tensor, *,
                                bits: int, inv_rotate_v: bool = True
                                ) -> torch.Tensor:
    """q (B,K,G,dh) f32; kw/vw (B,C,K,dh·bits/32) int32; ks/vs (B,C,K) f32;
    kv_len (B,) int32 → (B,K,G,dh) f32. All contiguous CUDA tensors."""
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"bits must be in {{1,2,4,8}}, got {bits}")
    _check_cuda_f32("q", q)
    _check_cuda_f32("ks", ks)
    _check_cuda_f32("vs", vs)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, K, G, dh), got {tuple(q.shape)}")
    b, kh, g, dh = q.shape
    if dh & (dh - 1) or not 0 < dh <= MAX_N or (dh * bits) % 32:
        raise ValueError(f"dh={dh} must be a power of 2 ≤ {MAX_N} with "
                         f"dh·bits/32 whole (bits={bits})")
    for name, t in (("kw", kw), ("vw", vw), ("kv_len", kv_len)):
        if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 CUDA tensor")
    c = kw.shape[1] if kw.dim() == 4 else 0
    want_w = (b, c, kh, dh * bits // 32)
    if tuple(kw.shape) != want_w or tuple(vw.shape) != want_w:
        raise ValueError(f"kw/vw shapes {tuple(kw.shape)}, {tuple(vw.shape)}"
                         f" != {want_w}")
    if tuple(ks.shape) != want_w[:3] or tuple(vs.shape) != want_w[:3]:
        raise ValueError(f"ks/vs shapes {tuple(ks.shape)}, {tuple(vs.shape)}"
                         f" != {want_w[:3]}")
    if c < 1:
        raise ValueError("the cache needs at least one position")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len shape {tuple(kv_len.shape)} != ({b},)")
    tc = tile_len(dh)
    if smem_bytes(g, dh, tc) > MAX_SMEM_BYTES:
        raise ValueError(f"G={g}, dh={dh} needs {smem_bytes(g, dh, tc)} B of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    fn = _build.library("quantdecode").ndsc_quant_decode_attention
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), kw.data_ptr(), ks.data_ptr(), vw.data_ptr(),
                vs.data_ptr(), kv_len.data_ptr(), out.data_ptr(), b, c, kh, g,
                dh, bits, tc, int(inv_rotate_v),
                float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)),
                _stream(q))
    _build.check(rc, "quant_decode_attention")
    quant_decode_attention_cuda.launches += 1
    return out


quant_decode_attention_cuda.launches = 0
