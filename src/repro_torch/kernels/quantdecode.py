"""CUDA kernel: fused dequantize + flash-decode GQA attention over the
NDSC-packed KV cache (`csrc/quantdecode.cu`).

Counterpart of `repro.kernels.quantdecode.quant_decode_attention_pallas`,
held to `ref.quant_decode_attention` within rtol = atol = 2e-4, the bound
the JAX package holds its Pallas kernel to; not bitwise, since the
exponentials and sums run in another order. Unlike the TPU kernel there is
no `block_c`: any cache length C >= 1 works, and the tile length is chosen
here.

The cache is split across blocks (`num_splits`, from the shapes and the
card's SM count, never from kv_len, which lives on the card): each split
writes a partial (m, l, acc) per query row into a scratch tensor and a
combining kernel merges them; with one split the first kernel writes the
output itself. G ≤ 8 query rows of 32 ≤ dh ≤ 256 (`warp_path`, yi-6b's
G 8, dh 128 among them) run the warp-resident kernel, which holds the
rows in registers; other shapes run the shared-memory tile kernel. The
launch path keeps the host's work small, as the FWHT's does: the ctypes
function, the f32 constant and the split plan are cached, and the device
guard is entered only when the tensor's card is not current.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import (_check_cuda_f32, _stream, call_on,
                                      inv_sqrt)

MAX_DH = 8192                 # the largest head width the kernels take
TILE_FLOATS = 8192            # dequantized K (or V) floats per tile
MAX_TILE = 64                 # positions per tile
MAX_SMEM_BYTES = 232448       # an H100 block's dynamic shared memory
# splits aim for this many blocks per SM: at least two, and enough that the
# last wave of blocks is a small part of the run (with 2, the long shape's
# 384 blocks of the warp-resident kernel fill 1.45 waves of its 264
# resident slots on an H100; PERF.md has the times)
BLOCKS_PER_SM = 8
WARP_ROWS = 8                 # query rows the warp-resident kernel holds
WARP_TILE = 64                # its tile: 8 positions for each of 8 warps


def warp_path(g: int, dh: int) -> bool:
    """Whether the warp-resident kernel takes G query rows of dh: G ≤ 8
    rows of 32 ≤ dh ≤ 256 coordinates fit a lane's registers."""
    return g <= WARP_ROWS and 32 <= dh <= 256


def tile_len(dh: int) -> int:
    """Cache positions per tile of the shared-memory kernel: 64, fewer
    when dh > 128."""
    return max(1, min(MAX_TILE, TILE_FLOATS // dh))


def smem_bytes(g: int, dh: int, tc: int) -> int:
    """Shared memory of one block: q and acc (g·dh each), the K tile with
    a padded row (tc·(dh+4)), the V tile (tc·dh), the probabilities (g·tc)
    and three running values per row."""
    return 4 * (2 * g * dh + tc * (2 * dh + 4) + g * tc + 3 * g)


def num_splits(b: int, kh: int, c: int, tc: int, sm_count: int) -> int:
    """Splits of a cache of c positions for b·kh (batch, kv-head) pairs:
    about BLOCKS_PER_SM blocks per SM, at most one per tile of tc, each a
    whole number of tiles and none empty (`split_len`)."""
    tiles = -(-c // tc)
    want = -(-BLOCKS_PER_SM * sm_count // max(1, b * kh))
    per = -(-tiles // max(1, min(want, tiles)))
    return -(-tiles // per)


def split_len(c: int, tc: int, s: int) -> int:
    """Positions per split when s splits cover c positions in tiles of tc:
    split i holds [i·L, min((i+1)·L, c))."""
    return -(-(-(-c // tc)) // s) * tc


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def plan(b: int, kh: int, c: int, g: int, dh: int, index: int) -> tuple:
    """(tile, splits, split length) of a call on card `index`; raises
    where the tile kernel would need more shared memory than a block has."""
    tc = WARP_TILE if warp_path(g, dh) else tile_len(dh)
    if not warp_path(g, dh) and smem_bytes(g, dh, tc) > MAX_SMEM_BYTES:
        raise ValueError(f"G={g}, dh={dh} needs {smem_bytes(g, dh, tc)} B of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")
    s = num_splits(b, kh, c, tc, sm_count(index))
    return tc, s, split_len(c, tc, s)


@functools.cache
def _kernel():
    return _build.library("quantdecode").ndsc_quant_decode_attention


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
    if dh & (dh - 1) or not 0 < dh <= MAX_DH or (dh * bits) % 32:
        raise ValueError(f"dh={dh} must be a power of 2 ≤ {MAX_DH} with "
                         f"dh·bits/32 whole (bits={bits})")
    for name, t in (("kw", kw), ("vw", vw), ("kv_len", kv_len)):
        if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 CUDA tensor")
    c = kw.shape[1] if kw.dim() == 4 else 0
    want_w = (b, c, kh, dh * bits // 32)
    if kw.shape != want_w or vw.shape != want_w:
        raise ValueError(f"kw/vw shapes {tuple(kw.shape)}, {tuple(vw.shape)}"
                         f" != {want_w}")
    if ks.shape != want_w[:3] or vs.shape != want_w[:3]:
        raise ValueError(f"ks/vs shapes {tuple(ks.shape)}, {tuple(vs.shape)}"
                         f" != {want_w[:3]}")
    if c < 1:
        raise ValueError("the cache needs at least one position")
    if kv_len.shape != (b,):
        raise ValueError(f"kv_len shape {tuple(kv_len.shape)} != ({b},)")
    tc, s, length = plan(b, kh, c, g, dh, q.device.index)
    out = torch.empty_like(q)
    # the splits' accumulators, then their (m, l) pairs
    part = (torch.empty(b * kh * s * g * (dh + 2), device=q.device)
            if s > 1 else None)
    rc = call_on(q, _kernel(), q.data_ptr(), kw.data_ptr(), ks.data_ptr(),
                 vw.data_ptr(), vs.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), None if part is None else part.data_ptr(),
                 b, c, kh, g, dh, bits, tc, s, length,
                 int(inv_rotate_v), inv_sqrt(dh), _stream(q))
    _build.check(rc, "quant_decode_attention")
    quant_decode_attention_cuda.launches += 1
    return out


quant_decode_attention_cuda.launches = 0
