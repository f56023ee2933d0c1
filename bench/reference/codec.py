"""Plain reference of the chunked NDSC gradient codec (paper §2.1,
Alg. 1's encoder with error feedback), in NumPy and plain PyTorch.

A leaf is flattened, zero-padded to rows of `chunk` values, and each row
is embedded with a randomized Hadamard frame: x ↦ H·D·x, D the ±1
diagonal of the leaf, H the normalized Walsh–Hadamard matrix. The row's
ℓ∞ norm is its scale; each value is cut to one of 2^R uniform cells on
[−scale, scale] and decoded to the cell's midpoint; the decode applies
D·H. With error feedback the worker keeps u − D(E(u)).

The frame's signs are Rademacher draws under Threefry-2x32 (Salmon et
al., SC'11), keyed as the reference JAX program keys them
(`jax.random`: key(seed), fold_in(leaf index), the first half of a
split, 32 random bits per value, a uniform in [0, 1) from the top 23
bits, sign +1 where it is below 0.5). They are derived here in NumPy
from the codec seed, independently of the program.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint64(0x1BD11BDA)


def _rotl(x, r):
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on uint64 arrays holding 32-bit words."""
    k1, k2 = np.uint64(k1), np.uint64(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (np.asarray(x1, np.uint64) + ks[0]) & _M32
    x2 = (np.asarray(x2, np.uint64) + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return x1, x2


def _fold_in(key, data):
    y1, y2 = threefry2x32(key[0], key[1], np.uint64(0),
                          np.uint64(data) & _M32)
    return int(y1), int(y2)


def _split_first(key):
    y1, y2 = threefry2x32(key[0], key[1], np.uint64(0), np.uint64(0))
    return int(y1), int(y2)


def frame_signs(codec_seed: int, leaf: int, chunk: int) -> np.ndarray:
    """±1 (float32) diagonal D of leaf `leaf`'s frame."""
    key = (0, codec_seed & 0xFFFFFFFF)
    ks = _split_first(_fold_in(key, leaf))
    idx = np.arange(chunk, dtype=np.uint64)
    y1, y2 = threefry2x32(ks[0], ks[1], idx >> np.uint64(32), idx & _M32)
    bits = (y1 ^ y2).astype(np.uint32)
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return np.where(u - np.float32(1.0) < np.float32(0.5), 1.0,
                    -1.0).astype(np.float32)


def hadamard(x: torch.Tensor) -> torch.Tensor:
    """Normalized Walsh–Hadamard transform of each row (last axis, a power
    of two), by butterflies."""
    n = x.shape[-1]
    y = x.reshape(-1, n)
    h = 1
    while h < n:
        y = y.reshape(-1, n // (2 * h), 2, h)
        y = torch.stack([y[:, :, 0] + y[:, :, 1], y[:, :, 0] - y[:, :, 1]],
                        dim=2)
        h *= 2
    return (y.reshape(x.shape) * float(n) ** -0.5)


def roundtrip(u: torch.Tensor, signs: torch.Tensor, bits: int,
              chunk: int, block_rows: int = 1 << 16) -> torch.Tensor:
    """D(E(u)) for one leaf u (any shape, float32): the decoded leaf, of
    u's shape. Rows are coded `block_rows` at a time."""
    flat = u.reshape(-1)
    rows = -(-flat.numel() // chunk)
    out = torch.empty(rows * chunk, dtype=torch.float32, device=u.device)
    cells = 2 ** bits
    tiny = torch.finfo(torch.float32).tiny
    for r0 in range(0, rows, block_rows):
        r1 = min(rows, r0 + block_rows)
        x = flat[r0 * chunk:r1 * chunk]
        if x.numel() < (r1 - r0) * chunk:
            x = torch.nn.functional.pad(x, (0, (r1 - r0) * chunk - x.numel()))
        y = hadamard(x.reshape(r1 - r0, chunk) * signs)
        scale = y.abs().amax(dim=1, keepdim=True)
        unit = torch.clamp(y / torch.clamp_min(scale, tiny), -1.0, 1.0)
        cell = torch.clamp(torch.floor((unit + 1.0) * (cells / 2.0)),
                           0, cells - 1)
        y_hat = (-1.0 + (2.0 * cell + 1.0) / cells) * scale
        out[r0 * chunk:r1 * chunk] = (hadamard(y_hat) * signs).reshape(-1)
    return out[:flat.numel()].reshape(u.shape)
