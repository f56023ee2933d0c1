"""Threefry2x32 keys and the samplers the NDSC codec draws from.

Bitwise equal to `jax.random` (jax 0.9.0, `jax_threefry_partitionable=True`,
x64 off) for the calls the codec makes: `key`, `fold_in`, `split`,
`uniform(minval, maxval)` in float32 and `rademacher`. Shared randomness is
part of the wire: frame signs, dithers and keep masks must agree bit for bit
with the reference, so every worker (and every framework) decodes alike.

A key is an int64 tensor of shape (2,) holding two uint32 words. All
arithmetic runs in int64 tensor ops masked to 32 bits (torch has no full
uint32 arithmetic), so the same code runs on the CPU and on the card.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# largest number of counters hashed at once: bounds the int64 temporaries
_BLOCK = 1 << 24


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2) under
    the key (k1, k2); all values uint32 held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.key(seed)` for a 32-bit seed: the pair (0, seed)."""
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed must fit 32 bits, got {seed}")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _words(k: torch.Tensor):
    k = k.to(torch.int64)
    return k[0], k[1]


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in`: hash the counter pair (0, data) under k."""
    k1, k2 = _words(k)
    x = torch.tensor([0, int(data) & _M32], dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k1, k2, x[:1], x[1:])
    return torch.cat([y1, y2])


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` (partitionable): key i = hash of counter (0, i)."""
    k1, k2 = _words(k)
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=1)


def random_bits32(k: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)): bits1 ^ bits2 of the
    hash of the flat row-major index, split into (hi, lo) words."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    k1, k2 = _words(k)
    out = torch.empty(n, dtype=torch.int64, device=k.device)
    for start in range(0, n, _BLOCK):
        idx = torch.arange(start, min(n, start + _BLOCK), dtype=torch.int64,
                           device=k.device)
        y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
        out[start:start + idx.numel()] = y1 ^ y2
    return out.reshape(shape)


def uniform(k: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32 on [minval, maxval).

    The 23 high bits fill the mantissa of a float in [1, 2); the result is
    max(minval, f·(maxval − minval) + minval) rounded step by step. (For
    the codec's ranges, widths that are powers of two, the product is exact,
    so a fused multiply-add in the reference would give the same bits.)"""
    bits = random_bits32(k, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(k: torch.Tensor, shape, p: float = 0.5) -> torch.Tensor:
    """`jax.random.bernoulli` (mode 'low'): uniform < p."""
    return uniform(k, shape) < p


def rademacher(k: torch.Tensor, shape, dtype=torch.int8) -> torch.Tensor:
    """`jax.random.rademacher`: ±1 from a fair Bernoulli draw."""
    return (2 * bernoulli(k, shape).to(dtype) - 1).to(dtype)
