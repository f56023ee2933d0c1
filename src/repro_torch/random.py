"""Threefry2x32 keys and the samplers the codec and the algorithms draw from.

Bitwise equal to `jax.random` (jax 0.9.0, `jax_threefry_partitionable=True`,
x64 off) for the calls the codec and the paper's algorithms make: `key`,
`fold_in`, `split`, `uniform(minval, maxval)` in float32, `rademacher`,
`permutation` and int32 `randint`. Shared randomness is part of the wire:
frame signs, rows, dithers and keep masks must agree bit for bit with the
reference, so every worker (and every framework) decodes alike. `normal` is
not bitwise: it spells XLA's f32 `erf_inv` polynomial in tensor ops, whose
`log1p` is torch's, not XLA's (~99% of draws bitwise, the rest within a
few ulps).

A key is an int64 tensor of shape (2,) holding two uint32 words. A stack of
keys, shape (..., 2), draws one row per key, each row bitwise equal to the
draw under that key alone (what `jax.vmap` over the keys gives). All
arithmetic runs in int64 tensor ops masked to 32 bits (torch has no full
uint32 arithmetic), so the same code runs on the CPU and on the card.

A hash is ~170 tensor ops whatever its size, so a loop that draws a few
numbers per step under key t of `split(key, steps)` would spend its time
launching them. `KeyStack` holds a loop's step keys; its `StepKey`s pass
through `split`, `split2` and the samplers like keys, and each distinct draw
is made for a block of steps at once (one hash over steps × shape
counters, at most `_DRAW_BLOCK` values) and read back by row: the same
bits, a view per step.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# largest number of counters hashed at once: bounds the int64 temporaries
_BLOCK = 1 << 24
# largest number of values a KeyStack draws ahead for one kind of draw
_DRAW_BLOCK = 1 << 22


class KeyStack:
    """The keys of every step of a loop, (steps, ..., 2). `at(t)` is step
    t's key; a draw under it is made for a block of steps at once.

    t is a Python int, or a 0-d int64 tensor on the keys' device: the step
    index a captured step program receives (`repro_torch.graph`). Under a
    tensor t a draw is a row read from its block (`index_select`, no host
    read), and the block is made outside the step: the first draw at the
    host step `step(t)` last set, and again, in place, whenever `step`
    moves t into another block. So a captured step reads every block at a
    fixed address, and a loop calls `step(t)` before step t."""

    def __init__(self, keys: torch.Tensor, _root: "KeyStack" = None):
        self.keys = keys
        self._memo = {}
        # the loop's host step and every block of this stack and of the
        # stacks derived from it (split, split2), refilled by step()
        self._root = self if _root is None else _root
        if _root is None:
            self._t = 0
            self._blocks: list = []

    def at(self, t) -> "StepKey":
        return StepKey(self, t)

    def step(self, t: int) -> None:
        """Step t is next: every block t has left is redrawn in place."""
        root = self._root
        root._t = t
        for blk in root._blocks:
            if t // blk.size != blk.b:
                blk.fill(t // blk.size)

    def draw(self, fn, t, shape, *args):
        """Step t's row of fn(step keys, (steps,) + shape, *args), drawn for
        a block of steps at once; the latest block of each draw is kept."""
        shape = tuple(shape)
        memo_key = (fn.__name__, shape, args)
        hit = self._memo.get(memo_key)
        if hit is None:
            hit = self._memo[memo_key] = _Block(self, fn, shape, args)
        if isinstance(t, torch.Tensor):
            if hit.buf is None:
                hit.fill(self._root._t // hit.size)
                self._root._blocks.append(hit)
            return hit.row(t)
        b, i = divmod(t, hit.size)
        if hit.b != b:
            hit.buf, hit.b = hit.make(b), b
        return hit.buf[i]


class _Block:
    """A KeyStack's draw for one block of steps: at most `_DRAW_BLOCK`
    values, the rows of steps [b·size, (b + 1)·size)."""

    def __init__(self, stack: KeyStack, fn, shape: tuple, args: tuple):
        self.stack, self.fn, self.shape, self.args = stack, fn, shape, args
        self.size = max(1, _DRAW_BLOCK // max(1, math.prod(shape)))
        self.b, self.buf = None, None

    def make(self, b: int) -> torch.Tensor:
        keys = self.stack.keys[b * self.size:(b + 1) * self.size]
        return self.fn(keys, (keys.shape[0],) + self.shape, *self.args)

    def fill(self, b: int) -> None:
        """Block b into the buffer, in place (a last, shorter block fills
        its first rows)."""
        new = self.make(b)
        if self.buf is None:
            rows = min(self.size, self.stack.keys.shape[0])
            self.buf = (new if new.shape[0] == rows else
                        new.new_empty((rows,) + tuple(new.shape[1:])))
        if self.buf is not new:
            self.buf[:new.shape[0]].copy_(new)
        self.b = b

    def row(self, t: torch.Tensor) -> torch.Tensor:
        """The row of step t (a 0-d tensor) in the current block."""
        i = torch.remainder(t, self.size).reshape(1)
        return self.buf.index_select(0, i)[0]


class StepKey:
    """Key t of a KeyStack (see the module docstring); t an int or a 0-d
    tensor (see `KeyStack`)."""

    __slots__ = ("stack", "t")

    def __init__(self, stack: KeyStack, t):
        self.stack, self.t = stack, t

    @property
    def value(self) -> torch.Tensor:
        """The key itself, (..., 2)."""
        if isinstance(self.t, torch.Tensor):
            return self.stack.keys.index_select(0, self.t.reshape(1))[0]
        return self.stack.keys[self.t]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2) under
    the key (k1, k2); all values uint32 held in int64 tensors (a counter
    may be a Python int, broadcast over the key's words)."""
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
    """`jax.random.key(seed)` for a 32-bit seed: the pair (0, seed), made
    on the device (no copy from the host, which a captured program
    cannot hold)."""
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed must fit 32 bits, got {seed}")
    return torch.arange(2, dtype=torch.int64, device=device) * (seed & _M32)


def _words(k: torch.Tensor):
    """The key's two words, each shaped (..., 1) so that they broadcast
    over a draw's counters."""
    k = k.to(torch.int64)
    return k[..., 0, None], k[..., 1, None]


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: hash the counter pair (0, data) under k.
    `data` is an int or a 0-d integer tensor (a traced step counter), its
    low 32 bits hashed either way, so both give the same bits."""
    k1, k2 = _words(k)
    if isinstance(data, torch.Tensor):
        lo = data.to(device=k.device, dtype=torch.int64) & _M32
    else:
        lo = int(data) & _M32
    y1, y2 = threefry2x32(k1, k2, 0, lo)
    return torch.cat([y1, y2], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` (partitionable): key i = hash of counter (0, i).
    k (..., 2) → (..., num, 2)."""
    if isinstance(k, StepKey):
        return _derived(k, split, num)
    k1, k2 = _words(k)
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


def split2(k: torch.Tensor):
    """`k1, k2 = jax.random.split(k)`, for a key or a stack of keys."""
    if isinstance(k, StepKey):
        return _derived(k, _half, 0), _derived(k, _half, 1)
    ks = split(k)
    return ks[..., 0, :], ks[..., 1, :]


def _half(k: torch.Tensor, i: int) -> torch.Tensor:
    """Half i of split(k)."""
    return split2(k)[i]


def _derived(k: StepKey, fn, arg) -> StepKey:
    """Step t's key of the KeyStack fn(all step keys, arg), memoized."""
    memo_key = ("keystack", fn.__name__, arg)
    memo = k.stack._memo
    if memo_key not in memo:
        memo[memo_key] = KeyStack(fn(k.stack.keys, arg), k.stack._root)
    return memo[memo_key].at(k.t)


def random_bits32(k: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)): bits1 ^ bits2 of the
    hash of the flat row-major index, split into (hi, lo) words.

    Under a stack of keys k (*B, 2), `shape` starts with B and key i hashes
    its own row of shape[len(B):]."""
    if isinstance(k, StepKey):
        return k.stack.draw(random_bits32, k.t, shape)
    shape = tuple(shape)
    lead = tuple(k.shape[:-1])
    if shape[:len(lead)] != lead:
        raise ValueError(f"shape {shape} must start with the key stack's "
                         f"shape {lead}")
    n = math.prod(shape[len(lead):])
    k1, k2 = _words(k)
    out = torch.empty(lead + (n,), dtype=torch.int64, device=k.device)
    for start in range(0, n, _BLOCK):
        idx = torch.arange(start, min(n, start + _BLOCK), dtype=torch.int64,
                           device=k.device)
        y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
        out[..., start:start + idx.numel()] = y1 ^ y2
    return out.reshape(shape)


def uniform(k: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32 on [minval, maxval).

    The 23 high bits fill the mantissa of a float in [1, 2); the result is
    max(minval, f·(maxval − minval) + minval) rounded step by step. (For
    the codec's ranges, widths that are powers of two, the product is exact,
    so a fused multiply-add in the reference would give the same bits.)"""
    if isinstance(k, StepKey):
        return k.stack.draw(uniform, k.t, shape, minval, maxval)
    bits = random_bits32(k, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their f32 difference as exact f32 values: a host
    # scalar multiplies and adds in f32 as a 0-d f32 tensor does, and is
    # no copy to the device
    lo = float(np.float32(minval))
    width = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(floats * width + lo, lo)


# XLA's f32 erf_inv (Giles' approximation): polynomial coefficients in w
# for w = −log1p(−x²) < 5 (evaluated at w − 2.5) and ≥ 5 (at √w − 3)
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 `erf_inv`, term for term: w = −log1p(−x·x), then a degree-8
    Horner polynomial in w − 2.5 (w < 5) or √w − 3, times x; ±1 map to
    ±inf. Each Horner step c + p·w is
    rounded once, as the fused multiply-add XLA's CPU code uses (exact in
    f64, then rounded to f32), and √w is the f64 root rounded to f32 (the
    correctly rounded f32 root). On the CPU, torch's f32 `sqrt` and
    `erfinv` are neither correctly rounded nor the same in every process:
    in some processes one worker thread's share of the elements comes out
    otherwise (up to 6.6e-5 relative for `erfinv`), which failed
    `test_normal_close` once."""
    f32 = torch.float32

    def c(v):
        return torch.full((), v, dtype=f32, device=x.device)

    w = -torch.log1p(-x * x)
    lt = w < c(5.0)
    root = torch.sqrt(w.double()).to(f32)        # correctly rounded, as XLA's
    w = torch.where(lt, w - c(2.5), root - c(3.0))
    p = torch.where(lt, c(_ERF_INV_LT5[0]), c(_ERF_INV_GE5[0]))
    w64 = w.double()
    for lo, hi in zip(_ERF_INV_LT5[1:], _ERF_INV_GE5[1:]):
        p = (torch.where(lt, c(lo), c(hi)).double()
             + p.double() * w64).to(f32)
    return torch.where(x.abs() == c(1.0), x * c(math.inf), p * x)


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.normal` in float32: √2·erf_inv(u) with u uniform on
    [nextafter(−1, 0), 1). u is bitwise the reference's, and `erf_inv` is
    XLA's polynomial; its log1p is torch's, so ~1% of draws differ from
    the reference's in the last bits."""
    if isinstance(k, StepKey):
        return k.stack.draw(normal, k.t, shape)
    u = uniform(k, shape, -(1.0 - 2.0 ** -24), 1.0)   # f32 nextafter(-1, 0)
    sqrt2 = torch.full((), math.sqrt(2.0), dtype=torch.float32,
                       device=k.device)
    return sqrt2 * erf_inv(u)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a·b) mod 2^32 for a, b < 2^32, with every product under 2^48."""
    return ((((a * (b >> 16)) & 0xFFFF) << 16) + a * (b & 0xFFFF)) & _M32


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """`jax.random.randint` in int32 on [minval, maxval): 32 high and 32 low
    bits (under the two halves of a split) folded modulo the span in
    uint32 arithmetic, products and sums wrapping at 32 bits, as jax does.
    maxval ≤ minval gives minval."""
    if isinstance(k, StepKey):
        return k.stack.draw(randint, k.t, shape, minval, maxval)
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise ValueError(f"bounds must fit int32, got {minval}, {maxval}")
    k1, k2 = split2(k)
    hi = random_bits32(k1, shape)
    lo = random_bits32(k2, shape)
    span = 1 if maxval <= minval else maxval - minval
    mult = (((2 ** 16 % span) ** 2) & _M32) % span
    offset = ((_mul32(hi % span, mult) + lo % span) & _M32) % span
    out = (minval + offset) & _M32
    return (out - ((out >> 31) << 32)).to(torch.int32)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)`: arange(n) in int32, stably sorted
    by fresh 32-bit draws in each of ceil(3·ln n / ln(2^32 − 1)) rounds
    (1 up to n = 1625, 2 from 1626); a round draws under the second half
    of a split of the key and carries the first half on."""
    if isinstance(k, StepKey):
        k = k.value
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))
    x = torch.arange(n, dtype=torch.int32, device=k.device)
    for _ in range(rounds):
        k, sub = split(k)
        x = x[torch.sort(random_bits32(sub, (n,)), stable=True).indices]
    return x


def bernoulli(k: torch.Tensor, shape, p: float = 0.5) -> torch.Tensor:
    """`jax.random.bernoulli` (mode 'low'): uniform < p."""
    if isinstance(k, StepKey):
        return k.stack.draw(bernoulli, k.t, shape, p)
    return uniform(k, shape) < p


def rademacher(k: torch.Tensor, shape, dtype=torch.int8) -> torch.Tensor:
    """`jax.random.rademacher`: ±1 from a fair Bernoulli draw."""
    return (2 * bernoulli(k, shape).to(dtype) - 1).to(dtype)
