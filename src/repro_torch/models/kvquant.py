"""NDSC-quantized KV cache (port of `repro.models.kvquant`).

Each cache entry, one (dh,)-vector per (position, kv-head), is stored
Hadamard-rotated with a fixed per-head sign vector D_h and uniformly
quantized at `bits` per element against its own ‖·‖∞ scale, as packed int32
words. Since H is orthonormal, ⟨q, k⟩ = ⟨Hq', Hk'⟩: queries are rotated
once per step and attention runs in the rotated basis; only the (G, dh)
output accumulator is inverse-rotated.

The wire format is the reference's bit for bit: the signs come from the
port's threefry (`repro_torch.random`, equal to `jax.random`), and
`ops.quantize_pack` is bitwise equal to `repro.kernels.ref.quantize_pack`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.kernels import ops as kernel_ops


class QuantKVCache(NamedTuple):
    k_words: torch.Tensor    # (L, B, C, K, dh·bits/32) int32
    k_scale: torch.Tensor    # (L, B, C, K) f32
    v_words: torch.Tensor
    v_scale: torch.Tensor


def head_signs(seed: int, layer: int, num_kv: int, dh: int,
               device=None) -> torch.Tensor:
    """±1 rotation signs per (kv-head, channel), deterministic per layer:
    `rademacher(fold_in(key(seed ^ 0x5EED), layer), (num_kv, dh))`."""
    key = rnd.fold_in(rnd.key(seed ^ 0x5EED, device=device), int(layer))
    return rnd.rademacher(key, (num_kv, dh)).to(torch.float32)


def rotate(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """x: (..., K, dh) → H(D x): rotated basis."""
    return kernel_ops.fwht(x * signs)


def init_cache(num_layers: int, batch: int, cache_len: int, num_kv: int,
               dh: int, bits: int, device=None) -> QuantKVCache:
    wpv = dh * bits // 32

    def z(dtype, *shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return QuantKVCache(
        k_words=z(torch.int32, num_layers, batch, cache_len, num_kv, wpv),
        k_scale=z(torch.float32, num_layers, batch, cache_len, num_kv),
        v_words=z(torch.int32, num_layers, batch, cache_len, num_kv, wpv),
        v_scale=z(torch.float32, num_layers, batch, cache_len, num_kv),
    )


def encode_entry(x: torch.Tensor, signs: torch.Tensor, bits: int):
    """x: (B, S, K, dh) new K or V → (words (B,S,K,wpv), scale (B,S,K))."""
    xr = rotate(x.to(torch.float32), signs)
    scale = torch.amax(torch.abs(xr), dim=-1)
    words = kernel_ops.quantize_pack(xr, scale[..., None], bits)
    return words, scale


def quant_decode_attention(q: torch.Tensor, cache_layer: tuple, kv_len,
                           signs: torch.Tensor, bits: int) -> torch.Tensor:
    """q: (B, 1, H, dh); cache_layer: (kw, ks, vw, vs) for ONE layer with
    shapes (B, C, K, …). Returns (B, 1, H, dh).

    The attention runs through `ops.quant_decode_attention`: the fused CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor. The
    reference chooses with a `use_pallas` argument that defaults to False
    (`repro/models/kvquant.py:72`), so its decode path never reaches the
    kernel; here the device decides, as for every other op, and the card
    always runs the kernel."""
    b, _, h, dh = q.shape
    kw, ks, vw, vs = cache_layer
    kh = kw.shape[2]
    g = h // kh
    scale = dh ** -0.5
    qg = q.reshape(b, kh, g, dh).to(torch.float32) * scale
    qr = kernel_ops.fwht(qg * signs[:, None, :])          # rotate queries
    lens = torch.as_tensor(kv_len, dtype=torch.int32,
                           device=q.device).expand(b)
    out = kernel_ops.quant_decode_attention(qr, kw, ks, vw, vs, lens,
                                            bits=bits)
    # inverse of the per-head D sign (H already inverted inside)
    out = out * signs[:, None, :]
    return out.reshape(b, 1, h, dh).to(q.dtype)
