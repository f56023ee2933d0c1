"""Chunked NDSC gradient codec (port of `repro.dist.gradcomp`).

Each parameter leaf is flattened, zero-padded to a multiple of `chunk` (a
power of two) and embedded chunk-wise with a randomized Hadamard frame
S = D·H; one ℓ∞ scale per chunk and uniform R-bit codes packed into int32
words go on the wire. The encode chain runs in one fused kernel on the card
(`kernels.ops.encode` / `encode_ef`), the decode in two
(`ops.unpack_dequant`, then the FWHT of `ops.unrotate`).

Shared randomness matches the reference bit for bit (`repro_torch.random`):
leaf i's frame signs are a function of (cfg.seed, i), and the per-round
dither and keep mask fold in `round_idx`. Leaves are numbered in
`jax.tree.flatten` order (`repro_torch.tree`), so payloads agree leaf by
leaf with the JAX package's.

Wire format per leaf (the payload dict):
  words  int32 (C, chunk·bits/32) — bit-packed codes
  scale  f32   (C, 1)             — per-chunk ‖x‖∞
  mask   f32   (C, 1)             — only when keep_fraction < 1
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch import random as rnd
from repro_torch import tree as tree_lib
from repro_torch.core import frames as frames_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import _div

STRATEGIES = ("psum", "psum_decoded", "allgather_packed", "alltoall_zero1")


@dataclasses.dataclass(frozen=True)
class GradCompConfig:
    """Budget + consensus strategy for compressed gradient exchange (see
    `repro.dist.gradcomp.GradCompConfig` for each field)."""

    bits: int = 4
    chunk: int = 256
    strategy: str = "allgather_packed"
    error_feedback: bool = True
    dithered: bool = False
    keep_fraction: float = 1.0
    exact_keep: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.bits not in (1, 2, 4, 8):
            raise ValueError(f"bits must be in {{1,2,4,8}}, got {self.bits}")
        if self.chunk < 32 or (self.chunk & (self.chunk - 1)):
            raise ValueError(
                f"chunk must be a power of two ≥ 32, got {self.chunk}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, "
                             f"got {self.strategy!r}")
        if not 0.0 < self.keep_fraction <= 1.0:
            raise ValueError(
                f"keep_fraction must be in (0, 1], got {self.keep_fraction}")

    @property
    def effective_bits(self) -> float:
        return self.bits * self.keep_fraction

    @property
    def words_per_chunk(self) -> int:
        return self.chunk * self.bits // 32

    def kept_chunks(self, c: int) -> int:
        if self.keep_fraction >= 1.0:
            return c
        return max(1, int(round(self.keep_fraction * c)))

    @property
    def compresses(self) -> bool:
        return self.strategy != "psum"

    @property
    def uses_ef(self) -> bool:
        return self.compresses and self.error_feedback


# ---------------------------------------------------------------------------
# Deterministic per-leaf randomness (shared across workers)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _cached_signs(seed: int, leaf_idx: int, chunk: int,
                  device: torch.device) -> torch.Tensor:
    key = rnd.fold_in(rnd.key(seed, device=device), leaf_idx)
    return frames_lib.hadamard_frame(key, chunk, chunk).signs.to(
        torch.float32)


def _frame_signs(leaf_idx: int, cfg: GradCompConfig,
                 device) -> torch.Tensor:
    """±1 f32 diagonal of leaf `leaf_idx`'s frame. The reference computes
    it once per trace; eager torch would redraw it every step, so it is
    cached per (seed, leaf, chunk, device). Callers must not modify it."""
    return _cached_signs(cfg.seed, int(leaf_idx), cfg.chunk,
                         torch.device(device))


@functools.lru_cache(maxsize=None)
def _cached_stoch_base(seed: int, leaf_idx: int,
                       device: torch.device) -> torch.Tensor:
    base = rnd.fold_in(rnd.key(seed, device=device), 0x5eed)
    return rnd.fold_in(base, leaf_idx)


def _stoch_key(leaf_idx: int, round_idx, cfg: GradCompConfig,
               device) -> torch.Tensor:
    """Key for the per-round stochastic parts (dither / keep-mask).
    `round_idx` is an int or a 0-d integer tensor (the train step's traced
    step counter: one captured program serves every step), the same bits
    either way. The leaf's key before the round is folded in is cached
    per (seed, leaf, device), as the frame signs are."""
    base = _cached_stoch_base(cfg.seed, int(leaf_idx), torch.device(device))
    return rnd.fold_in(base, round_idx)


# ---------------------------------------------------------------------------
# Leaf codec
# ---------------------------------------------------------------------------
def _to_chunks(x: torch.Tensor, chunk: int, lead: int = 0) -> torch.Tensor:
    """x as f32 rows of `chunk`, zero-padded: (C, chunk), or with `lead`
    leading lane axes kept, each lane flattened on its own."""
    lanes = tuple(x.shape[:lead])
    flat = x.to(torch.float32).reshape(lanes + (-1,))
    c = -(-flat.shape[-1] // chunk)
    flat = torch.nn.functional.pad(flat, (0, c * chunk - flat.shape[-1]))
    return flat.reshape(lanes + (c, chunk))


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the leading axis of t up to `rows`."""
    if t.shape[0] == rows:
        return t
    pad = t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([t, pad])


def _exact_keep_mask(draw: torch.Tensor, k: int) -> torch.Tensor:
    """Keep EXACTLY the k smallest of the (..., C, 1) draws: stable double
    argsort, ties broken by chunk index (identical on every worker)."""
    order = torch.argsort(draw[..., 0], dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return (rank < k)[..., None]


def _leaf_draws(leaf_idx: int, lc: int, rows: int, cfg: GradCompConfig,
                round_idx: int, key, device) -> tuple:
    """Pre-drawn (dither (rows, chunk) | None, mask f32 (rows, 1) | None),
    drawn at the logical chunk count `lc`, zero-extended over padding.
    Under a stack of keys (L, 2) (one per lane, rows == lc) each draw gets
    a leading lane axis, lane l's bitwise the draw under key l alone."""
    if key is None and (cfg.dithered or cfg.keep_fraction < 1.0):
        key = _stoch_key(leaf_idx, round_idx, cfg, device)
    lead = () if key is None else tuple(key.shape[:-1])
    dither = None
    if cfg.dithered:
        delta = 2.0 / (2 ** cfg.bits)
        dither = rnd.uniform(rnd.fold_in(key, 1), lead + (lc, cfg.chunk),
                             minval=-delta / 2, maxval=delta / 2)
        dither = dither if lead else _pad_rows(dither, rows)
    mask = None
    if cfg.keep_fraction < 1.0:
        draw = rnd.uniform(rnd.fold_in(key, 2), lead + (lc, 1))
        if cfg.exact_keep:
            keep = _exact_keep_mask(draw, cfg.kept_chunks(lc))
        else:
            keep = draw < cfg.keep_fraction
        mask = keep.to(torch.float32)
        mask = mask if lead else _pad_rows(mask, rows)
    return dither, mask


def _lead(key) -> int:
    """Lane axes of a key: 0 for one key (2,), 1 for a stack (L, 2)."""
    return 0 if key is None else key.ndim - 1


def encode_leaf(x: torch.Tensor, leaf_idx: int, cfg: GradCompConfig,
                round_idx: int = 0, key=None,
                logical_chunks: int | None = None) -> dict:
    """Encode one leaf → payload dict (see the module docstring). Under a
    stack of keys (L, 2), x is L lanes (L, ...) encoded in one kernel
    launch, lane l under key l: the payload gains a leading lane axis, and
    lane l is bitwise lane l's encode alone."""
    chunks = _to_chunks(x, cfg.chunk, _lead(key))
    lc = chunks.shape[-2] if logical_chunks is None else logical_chunks
    signs = _frame_signs(leaf_idx, cfg, x.device)
    dither, mask = _leaf_draws(leaf_idx, lc, chunks.shape[-2], cfg,
                               round_idx, key, x.device)
    words, scale = kernel_ops.encode(chunks, signs, cfg.bits,
                                     dither=dither, mask=mask)
    payload = {"words": words, "scale": scale}
    if mask is not None:
        payload["mask"] = mask
    return payload


def encode_leaf_ef(x: torch.Tensor, leaf_idx: int, cfg: GradCompConfig,
                   round_idx: int = 0, key=None,
                   logical_chunks: int | None = None,
                   residual_dtype=None) -> tuple:
    """`encode_leaf` plus the error-feedback residual u − D(E(u)), of x's
    shape and dtype (lanes as in `encode_leaf`). The 1/keep rescale
    applies only on the dithered, non-EF path; the decode rounds through
    `residual_dtype` (x's dtype by default) before the subtract."""
    lead = _lead(key)
    chunks = _to_chunks(x, cfg.chunk, lead)
    lc = chunks.shape[-2] if logical_chunks is None else logical_chunks
    signs = _frame_signs(leaf_idx, cfg, x.device)
    dither, mask = _leaf_draws(leaf_idx, lc, chunks.shape[-2], cfg,
                               round_idx, key, x.device)
    rescale = (cfg.keep_fraction
               if (mask is not None and cfg.dithered
                   and not cfg.error_feedback) else None)
    rdt = x.dtype if residual_dtype is None else residual_dtype
    words, scale, resid = kernel_ops.encode_ef(
        chunks, signs, cfg.bits, dither=dither, mask=mask,
        rescale=rescale, residual_dtype=rdt)
    payload = {"words": words, "scale": scale}
    if mask is not None:
        payload["mask"] = mask
    lanes = tuple(x.shape[:lead])
    residual = resid.reshape(lanes + (-1,))[..., :math.prod(x.shape[lead:])]
    return payload, residual.reshape(x.shape).to(x.dtype)


def decode_leaf(payload: dict, leaf_idx: int, size: int, shape, dtype,
                cfg: GradCompConfig, extra_lead: int = 0) -> torch.Tensor:
    """Decode a payload back to a leaf of `shape`; with `extra_lead` = k the
    payload carries k leading stacked axes, kept in the result."""
    words, scale = payload["words"], payload["scale"]
    x_hat = kernel_ops.unpack_dequant(words, scale, cfg.bits, cfg.chunk)
    mask = payload.get("mask")
    if mask is not None:
        x_hat = x_hat * mask
        if cfg.dithered and not cfg.error_feedback:
            # unbiased 1/keep rescale (DQ-PSGD); EF stays contractive
            x_hat = _div(x_hat, cfg.keep_fraction)
    signs = _frame_signs(leaf_idx, cfg, x_hat.device).to(x_hat.dtype)
    y = kernel_ops.unrotate(x_hat, signs)                    # y = D·H·x̂
    lead = tuple(words.shape[:extra_lead])
    flat = y.reshape(lead + (-1,))[..., :size]
    return flat.reshape(lead + tuple(shape)).to(dtype)


# ---------------------------------------------------------------------------
# Tree codec
# ---------------------------------------------------------------------------
def compress_tree(tree, cfg: GradCompConfig, round_idx: int = 0):
    """Encode every leaf. Returns (payload tree, (spec, leaf infos))."""
    leaves, spec = tree_lib.flatten(tree)
    payloads = [encode_leaf(x, i, cfg, round_idx)
                for i, x in enumerate(leaves)]
    meta = (spec, [(x.numel(), tuple(x.shape), x.dtype) for x in leaves])
    return tree_lib.unflatten(spec, payloads), meta


def _payload_leaves(payloads) -> list:
    """Flatten a payload tree to its per-leaf {"words", "scale", ...} dicts."""
    return tree_lib.leaves(
        payloads, is_leaf=lambda d: isinstance(d, dict) and "words" in d)


def decode_payload(payloads, meta, cfg: GradCompConfig, extra_lead: int = 0):
    """Inverse of compress_tree; `extra_lead` as in decode_leaf."""
    spec, infos = meta
    plist = _payload_leaves(payloads)
    outs = [decode_leaf(p, i, size, shape, dtype, cfg, extra_lead=extra_lead)
            for i, (p, (size, shape, dtype)) in enumerate(zip(plist, infos))]
    return tree_lib.unflatten(spec, outs)


# ---------------------------------------------------------------------------
# Wire audit
# ---------------------------------------------------------------------------
def wire_bytes_tree(tree, cfg: GradCompConfig, num_workers: int = 1) -> dict:
    """Exact bytes a worker puts on the wire per step, vs f32 all-reduce:
    per kept chunk chunk·bits/8 payload bytes + a 4-byte scale, plus a
    1-bit-per-chunk mask in the sub-linear regime. Leaves may be tensors
    or anything with a `.shape`."""
    f32_bytes = 0
    payload_bytes = 0.0
    for leaf in tree_lib.leaves(tree):
        size = math.prod(leaf.shape)
        f32_bytes += size * 4
        c = -(-size // cfg.chunk)
        per_chunk = cfg.chunk * cfg.bits // 8 + 4
        if cfg.keep_fraction < 1.0:
            kept = (cfg.kept_chunks(c) if cfg.exact_keep
                    else cfg.keep_fraction * c)
            payload_bytes += kept * per_chunk + (c + 7) // 8
        else:
            payload_bytes += c * per_chunk
    if cfg.keep_fraction >= 1.0 or cfg.exact_keep:
        payload_bytes = int(payload_bytes)
    return {
        "f32_bytes": f32_bytes,
        "payload_bytes": payload_bytes,
        "compression_x": f32_bytes / payload_bytes,
        "num_workers": num_workers,
        "allgather_rx_bytes": payload_bytes * max(num_workers - 1, 0),
    }


def wire_bytes_payload(payloads, cfg: GradCompConfig) -> float:
    """Bytes a concrete encoded tree puts on the wire (kept chunks only,
    per the realized mask) — the realized counterpart of wire_bytes_tree."""
    per_chunk = cfg.chunk * cfg.bits // 8 + 4
    total = 0.0
    for p in _payload_leaves(payloads):
        c = p["scale"].shape[-2]
        mask = p.get("mask")
        if mask is None:
            total += c * per_chunk
        else:
            total += float(mask.sum()) * per_chunk + (c + 7) // 8
    return total
