"""Codec stages and the `Pipeline` that assembles them (port of
`repro.codecs.stages`).

Every wire codec is four stages applied per leaf:

    transform  ─►  sparsify  ─►  quantize  ─►  pack
    hadamard       none          uniform       int32
    identity       chunk_drop    dithered      none
                   topk          ratq
                   randk

Three leaf codecs back the supported combinations:

  * **NDSC** (`NdscLeaf`) delegates to `repro_torch.dist.gradcomp`, as the
    reference delegates to `repro.dist.gradcomp`, which keeps its payloads
    identical to the gradcomp path and its `encode_ef` on the fused kernel;
  * **RATQ** (`RatqLeaf`): rotate (the FWHT kernel), pick each chunk's rung
    of a per-leaf geometric ladder, quantize and pack (the quantize_pack
    kernel);
  * **sparsify-then-embed** (`SparsifyEmbedLeaf`): top-k / rand-k survivors
    in original space, NDSC-encoded (the encode kernel).

The chunked leaves (NDSC, RATQ) also encode and decode a stack of lanes
(one client per lane, one key per lane) in one kernel launch per leaf;
lane l is bitwise the leaf's call on lane l alone. Stochastic draws come
from `fold_in`-derived keys outside any kernel, as in the reference, and
wire_bits / wire_bytes use the same per-leaf formulas, so the realized
ledger equals the audit to the byte for every deterministic-size codec.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch import random as rnd
from repro_torch import tree as tree_lib
from repro_torch.codecs import base
from repro_torch.codecs.base import TreeCodec, TreeMeta
from repro_torch.dist import gradcomp as G
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import TINY

TRANSFORMS = ("hadamard", "identity")
SPARSIFIERS = ("none", "chunk_drop", "topk", "randk")
QUANTIZERS = ("uniform", "dithered", "ratq")
PACKERS = ("int32", "none")

PACKABLE_BITS = (1, 2, 4, 8)

# RATQ's rung near each power of two 2^k, k = −126..0, where the
# reference's ⌈log2⌉ (XLA's CPU log2: log(x)·f32(1/ln 2), each rounded)
# departs from the exact one; x = 2^k with o ulps added. t > 0: at o in
# [1, t] the reference gives k (exact: k + 1); t < 0: at o in [t + 1, 0] it
# gives k + 1 (exact: k); 0: nowhere. Everywhere else the two agree (held
# by tests/test_torch_codecs.py against jnp at every o in [−128, 128]).
_RUNG_RUNS = (
    5, -12, -36, 34, 22, 10, -4, -28, 38, 26, 14, 2, -20, 42, 30, 18, 6,
    -12, -36, 34, 22, 10, -4, -28, 38, 26, 14, 2, -20, 42, 30, 18, 6, -11,
    30, 18, 6, 26, 14, 2, 22, 10, 30, 18, 6, 26, 14, 2, 22, 10, 30, 18, 6,
    26, 14, 2, 22, 10, 30, 18, 6, 26, 14, 2, -18, 11, -2, 19, 7, -10, 15, 3,
    -18, 11, -2, 19, 7, -10, 15, 3, 15, 3, 7, 11, 15, 3, 7, 11, 15, 3, 7,
    11, 15, 3, 7, -9, -1, 3, 7, -9, -1, 3, 7, 7, 3, 7, 3, 7, 3, 7, 3, -1, 3,
    -1, 3, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0)


@dataclasses.dataclass(frozen=True)
class Transform:
    """Per-chunk orthonormal rotation applied before quantization:
    `hadamard` is the randomized frame S = D·H, a pure function of (seed,
    leaf index)."""

    kind: str = "hadamard"
    seed: int = 0

    def __post_init__(self):
        if self.kind not in TRANSFORMS:
            raise ValueError(f"transform must be one of {TRANSFORMS}, "
                             f"got {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class Sparsify:
    """Which coordinates make it onto the wire (see the reference:
    `chunk_drop` after the transform, `topk` / `randk` before it)."""

    kind: str = "none"
    fraction: float = 1.0
    exact: bool = True
    rescale: bool = False

    def __post_init__(self):
        if self.kind not in SPARSIFIERS:
            raise ValueError(f"sparsify must be one of {SPARSIFIERS}, "
                             f"got {self.kind!r}")
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(
                f"sparsify fraction must be in (0, 1], got {self.fraction}")


@dataclasses.dataclass(frozen=True)
class Quantize:
    """Scalar quantizer: `uniform` / `dithered` with an f32 ℓ∞ scale per
    chunk, or `ratq` with a ⌈log2 ladder⌉-bit rung per chunk and one f32
    gain per leaf."""

    kind: str = "uniform"
    bits: int = 4
    ladder: int = 16              # ratq: number of geometric range rungs h

    def __post_init__(self):
        if self.kind not in QUANTIZERS:
            raise ValueError(f"quantize must be one of {QUANTIZERS}, "
                             f"got {self.kind!r}")
        if self.bits not in PACKABLE_BITS:
            raise ValueError(
                f"bits must be in {PACKABLE_BITS} (int32 packing), "
                f"got {self.bits}")
        if self.kind == "ratq" and self.ladder < 2:
            raise ValueError(f"ratq ladder needs ≥ 2 rungs, got {self.ladder}")


@dataclasses.dataclass(frozen=True)
class Pack:
    """Wire representation of the quantized indices."""

    kind: str = "int32"

    def __post_init__(self):
        if self.kind not in PACKERS:
            raise ValueError(f"pack must be one of {PACKERS}, "
                             f"got {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """One choice per stage + the chunk length, composed into a TreeCodec.
    Frozen and hashable: equal pipelines encode and decode identically."""

    transform: Transform = Transform()
    sparsify: Sparsify = Sparsify()
    quantize: Quantize = Quantize()
    pack: Pack = Pack()
    chunk: int = 128

    def leaf(self):
        """The per-leaf stage codec implementing this combination."""
        return _leaf_codec(self)

    def tree_codec(self, name: str, rate: Optional[float] = None) -> TreeCodec:
        return tree_codec(name, self, rate=rate)


# ---------------------------------------------------------------------------
# Pipeline -> leaf-codec dispatch
# ---------------------------------------------------------------------------
def _gradcomp_config(p: Pipeline) -> G.GradCompConfig:
    """The GradCompConfig equivalent of a chunked pipeline (`error_feedback`
    is the inverse of the sparsify stage's `rescale`)."""
    drop = p.sparsify.kind == "chunk_drop"
    dithered = p.quantize.kind == "dithered"
    return G.GradCompConfig(
        bits=p.quantize.bits, chunk=p.chunk,
        keep_fraction=p.sparsify.fraction if drop else 1.0,
        exact_keep=p.sparsify.exact if drop else False,
        dithered=dithered,
        error_feedback=not (p.sparsify.rescale and dithered and drop),
        seed=p.transform.seed)


@functools.lru_cache(maxsize=None)
def _leaf_codec(p: Pipeline):
    if p.sparsify.kind in ("topk", "randk"):
        if (p.transform.kind, p.quantize.kind, p.pack.kind) not in (
                ("hadamard", "uniform", "int32"),
                ("hadamard", "dithered", "int32")):
            raise ValueError(
                "topk/randk sparsify composes with transform='hadamard', "
                "quantize='uniform'|'dithered', pack='int32' "
                "(sparsify-then-embed); got "
                f"{p.transform.kind}/{p.quantize.kind}/{p.pack.kind}")
        return SparsifyEmbedLeaf(_gradcomp_config(p), p.sparsify.kind,
                                 p.sparsify.fraction)
    if p.transform.kind != "hadamard" or p.pack.kind != "int32":
        raise ValueError(
            "chunked pipelines need transform='hadamard' and pack='int32' "
            f"(got {p.transform.kind}/{p.pack.kind}); identity-transform "
            "baselines are built with `sim_pipeline`")
    if p.quantize.kind == "ratq":
        return RatqLeaf(_gradcomp_config(p), p.quantize.ladder)
    return NdscLeaf(_gradcomp_config(p))


# ---------------------------------------------------------------------------
# NDSC: delegate to repro_torch.dist.gradcomp (the fused-kernel stage impl)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NdscLeaf:
    """hadamard + (chunk_drop) + uniform/dithered + int32, delegating to
    `gradcomp`."""

    cfg: G.GradCompConfig
    fused_ef = True               # encode_ef emits the residual in the kernel
    lanes = True                  # encode / encode_ef take a key per lane

    @property
    def effective_bits(self) -> float:
        return self.cfg.effective_bits

    def encode(self, x, leaf_idx, round_idx=0, key=None):
        return G.encode_leaf(x, leaf_idx, self.cfg, round_idx, key=key)

    def encode_ef(self, x, leaf_idx, round_idx=0, key=None,
                  residual_dtype=None):
        return G.encode_leaf_ef(x, leaf_idx, self.cfg, round_idx, key=key,
                                residual_dtype=residual_dtype)

    def decode(self, payload, leaf_idx, size, shape, dtype, extra_lead=0):
        return G.decode_leaf(payload, leaf_idx, size, shape, dtype, self.cfg,
                             extra_lead=extra_lead)

    def wire_bits(self, size: int) -> float:
        template = torch.empty(int(size), device="meta")
        return G.wire_bytes_tree([template], self.cfg)["payload_bytes"] * 8.0

    def wire_bytes(self, payload, size: int) -> float:
        return G.wire_bytes_payload(payload, self.cfg)


def ndsc_leaf(cfg: G.GradCompConfig) -> NdscLeaf:
    """The NDSC stage codec for an explicit GradCompConfig (what
    `repro_torch.dist.step` routes its consensus encode/decode through)."""
    return NdscLeaf(cfg)


# ---------------------------------------------------------------------------
# RATQ: rotate + adaptive geometric range + fixed-length quantize
# ---------------------------------------------------------------------------
def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e in f32 for int32 e in the normal range, built from its exponent
    bits (exact on any device, as the reference's exp2 of an integer is)."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


@functools.lru_cache(maxsize=None)
def _rung_runs(device: torch.device) -> torch.Tensor:
    """_RUNG_RUNS indexed by the biased exponent k + 127 (1..127), copied
    to the device once (a captured program's first call runs eagerly, so
    its capture finds the copy made)."""
    return torch.tensor((0,) + _RUNG_RUNS, dtype=torch.int32, device=device)


def ratq_rung(rel: torch.Tensor, ladder: int) -> torch.Tensor:
    """The rung index clip(⌈log2(max(rel, 2^(1−h)))⌉ + h − 1, 0, h − 1),
    int32, bitwise the reference's (`repro/codecs/stages.py:289-291`).

    The rung is part of the wire, and a device's log2 (or log) may differ
    from XLA's by an ulp and flip it near the powers of two. So it is
    computed in integers from the f32 bits: the exact ⌈log2⌉ (the exponent,
    plus one when the mantissa is not zero), then the reference's
    departures from it near 2^k (`_RUNG_RUNS`). Identical on every device;
    needs h ≤ 127 (a normal floor)."""
    # the floor 2^(1−h) is exact in f32: a host scalar, no device copy
    bits = torch.clamp_min(rel.to(torch.float32),
                           2.0 ** (1 - ladder)).view(torch.int32)
    exact = (bits >> 23) - 127 + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    near = torch.clamp((bits + (1 << 22)) >> 23, 1, 127)  # nearest 2^k, biased
    off = bits - (near << 23)                             # ulps from it
    t = _rung_runs(rel.device)[near.to(torch.int64)]
    down = (t > 0) & (off >= 1) & (off <= t)
    up = (t < 0) & (off >= t + 1) & (off <= 0)
    rung = exact - down.to(torch.int32) + up.to(torch.int32)
    return torch.clamp(rung + (ladder - 1), 0, ladder - 1)


@dataclasses.dataclass(frozen=True)
class RatqLeaf:
    """hadamard + (chunk_drop) + ratq + int32 (Mayekar & Tyagi): per leaf
    one f32 gain ‖rot‖∞, per chunk the smallest rung 2^(j−(h−1)) ≥
    ‖row‖∞/gain, the row quantized at scale gain·2^(j−(h−1))."""

    cfg: G.GradCompConfig         # bits/chunk/keep_fraction/exact_keep/seed
    ladder: int
    fused_ef = False
    lanes = True                  # encode takes a key per lane

    @property
    def _ridx_bits(self) -> int:
        return max(1, math.ceil(math.log2(self.ladder)))

    def _scales(self, ridx, gain):
        safe = torch.clamp(gain, min=TINY)
        return safe * _pow2(ridx - (self.ladder - 1))

    def encode(self, x, leaf_idx, round_idx=0, key=None):
        """Under a stack of keys (L, 2), x is L lanes, each with its own
        gain, encoded in one launch of each kernel."""
        cfg = self.cfg
        chunks = G._to_chunks(x, cfg.chunk, G._lead(key))
        c = chunks.shape[-2]
        signs = G._frame_signs(leaf_idx, cfg, chunks.device)
        _, mask = G._leaf_draws(leaf_idx, c, c, cfg, round_idx, key,
                                chunks.device)
        rot = kernel_ops.rotate(chunks, signs)
        row_max = torch.amax(torch.abs(rot), dim=-1, keepdim=True)
        gain = torch.amax(row_max, dim=-2, keepdim=True)       # (..., 1, 1)
        rel = row_max / torch.clamp(gain, min=TINY)            # ∈ [0, 1]
        ridx = ratq_rung(rel, self.ladder)
        words = kernel_ops.quantize_pack(rot, self._scales(ridx, gain),
                                         cfg.bits)
        if mask is not None:
            # dropped chunks emit all-zero words + rung 0: no ghost info
            words = words * mask.to(words.dtype)
            ridx = ridx * mask.to(ridx.dtype)
        payload = {"words": words, "ridx": ridx, "gain": gain}
        if mask is not None:
            payload["mask"] = mask
        return payload

    def decode(self, payload, leaf_idx, size, shape, dtype, extra_lead=0):
        cfg = self.cfg
        words = payload["words"]
        scale = self._scales(payload["ridx"], payload["gain"])
        x_hat = kernel_ops.unpack_dequant(words, scale, cfg.bits, cfg.chunk)
        mask = payload.get("mask")
        if mask is not None:
            x_hat = x_hat * mask
        signs = G._frame_signs(leaf_idx, cfg, x_hat.device)
        y = kernel_ops.unrotate(x_hat, signs)
        lead = tuple(words.shape[:extra_lead])
        flat = y.reshape(lead + (-1,))[..., :size]
        return flat.reshape(lead + tuple(shape)).to(dtype)

    def _leaf_bytes(self, c: int, kept) -> float:
        per_chunk = (self.cfg.chunk * self.cfg.bits + self._ridx_bits) / 8.0
        total = kept * per_chunk + 4.0                    # + the f32 gain
        if self.cfg.keep_fraction < 1.0:
            total += (c + 7) // 8                         # the keep mask
        return total

    def wire_bits(self, size: int) -> float:
        c = -(-int(size) // self.cfg.chunk)
        if self.cfg.keep_fraction >= 1.0:
            kept = c
        elif self.cfg.exact_keep:
            kept = self.cfg.kept_chunks(c)
        else:
            kept = self.cfg.keep_fraction * c
        return self._leaf_bytes(c, kept) * 8.0

    def wire_bytes(self, payload, size: int) -> float:
        c = payload["ridx"].shape[-2]
        mask = payload.get("mask")
        kept = c if mask is None else float(mask.sum())
        return self._leaf_bytes(c, kept)


def _log2_comb(n: int, k: int) -> float:
    """log2 C(n,k): exact for small n (matching `core.baselines`), Stirling
    via lgamma past the point where the exact big integer gets expensive."""
    if n <= 65536:
        return math.log2(math.comb(n, k))
    lg = (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))
    return lg / math.log(2.0)


def top_indices(a: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of `a` (1-D), ties to the lower index, as
    `jax.lax.top_k` keeps them: a stable descending sort, whose tie order
    is fixed on every device (a bare `torch.topk`'s is not on CUDA)."""
    return torch.sort(a, descending=True, stable=True).indices[:k]


# ---------------------------------------------------------------------------
# sparsify-then-embed: original-space selection, embedded-space quantization
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SparsifyEmbedLeaf:
    """topk/randk + hadamard + uniform/dithered + int32 (paper Fig. 1d):
    k survivors selected in original space, gathered into a dense length-k
    vector and NDSC-encoded; the indices ride the wire, and the audit
    charges log2 C(n,k) for them."""

    cfg: G.GradCompConfig         # bits/chunk/dithered/seed (keep = 1)
    mode: str                     # "topk" | "randk"
    fraction: float
    fused_ef = False

    def _k(self, size: int) -> int:
        return max(1, min(int(size), int(round(self.fraction * size))))

    def encode(self, x, leaf_idx, round_idx=0, key=None):
        cfg = self.cfg
        flat = x.to(torch.float32).reshape(-1)
        n, k = flat.numel(), self._k(x.numel())
        if self.mode == "topk":
            idx = torch.sort(top_indices(torch.abs(flat), k)).values
        else:
            if key is None:
                key = G._stoch_key(leaf_idx, round_idx, cfg, x.device)
            draw = rnd.uniform(rnd.fold_in(key, 3), (n,))
            # rank trick: exactly k survivors, ties broken by index
            idx = torch.sort(torch.argsort(draw, stable=True)[:k]).values
        vals = flat[idx]
        chunks = G._to_chunks(vals, cfg.chunk)
        signs = G._frame_signs(leaf_idx, cfg, x.device)
        dither, _ = G._leaf_draws(leaf_idx, chunks.shape[0], chunks.shape[0],
                                  cfg, round_idx, key, x.device)
        words, scale = kernel_ops.encode(chunks, signs, cfg.bits,
                                         dither=dither, mask=None)
        return {"indices": idx.to(torch.int32), "words": words,
                "scale": scale}

    def decode(self, payload, leaf_idx, size, shape, dtype, extra_lead=0):
        if extra_lead:
            raise ValueError("sparsify_then_embed does not decode stacked "
                             "payloads (extra_lead > 0)")
        cfg = self.cfg
        idx = payload["indices"]
        x_hat = kernel_ops.unpack_dequant(payload["words"], payload["scale"],
                                          cfg.bits, cfg.chunk)
        signs = G._frame_signs(leaf_idx, cfg, x_hat.device)
        vals = kernel_ops.unrotate(x_hat, signs).reshape(-1)[:idx.shape[-1]]
        flat = torch.zeros(size, dtype=torch.float32, device=x_hat.device)
        flat[idx.to(torch.int64)] = vals
        return flat.reshape(shape).to(dtype)

    def wire_bits(self, size: int) -> float:
        n = int(size)
        k = self._k(n)
        c = -(-k // self.cfg.chunk)
        payload_bits = c * (self.cfg.chunk * self.cfg.bits + 32)
        return payload_bits + _log2_comb(n, k)

    def wire_bytes(self, payload, size: int) -> float:
        return self.wire_bits(size) / 8.0        # fixed-size wire


# ---------------------------------------------------------------------------
# tree assembly: per-leaf stage codecs -> the TreeCodec convention
# ---------------------------------------------------------------------------
def leaf_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """fold_in(key, i) for the n leaves i, in one hash: `split`'s key i
    hashes the counter (0, i) as `fold_in(key, i)` does (a hash is ~170
    eager ops whatever its size, so one per leaf would cost more host time
    than the codec's kernels). key (..., 2) → (..., n, 2)."""
    return rnd.split(key, n)


def tree_codec(name: str, pipeline, rate: Optional[float] = None,
               fused_ef: bool = True) -> TreeCodec:
    """Assemble a Pipeline (or one Pipeline per leaf) into a TreeCodec.

    Per-leaf keys fold in the leaf index; `meta.extra` carries the per-leaf
    stage codecs. When every leaf has the fused encode + EF path (NDSC) the
    codec exposes `encode_ef`. When every leaf takes a key per lane (NDSC,
    RATQ) it exposes `encode_lanes` / `decode_lanes` (and, with
    `encode_ef`, `encode_ef_lanes`): one kernel launch per leaf over all
    lanes."""
    shared = isinstance(pipeline, Pipeline)
    pipes = None if shared else list(pipeline)

    def leaves_for(n: int) -> list:
        if shared:
            return [pipeline.leaf()] * n
        if len(pipes) != n:
            raise ValueError(f"{len(pipes)} per-leaf pipelines for "
                             f"{n} leaves")
        return [p.leaf() for p in pipes]

    def encode(key, tree, round_idx=0):
        leaves, spec = tree_lib.flatten(tree)
        lcs = leaves_for(len(leaves))
        keys = leaf_keys(key, len(leaves))
        payloads = [lc.encode(x, i, round_idx, key=keys[..., i, :])
                    for i, (x, lc) in enumerate(zip(leaves, lcs))]
        return tree_lib.unflatten(spec, payloads)

    def meta(tree):
        spec, infos = base.tree_meta(tree)
        return TreeMeta(spec, infos, extra=leaves_for(len(infos)))

    def decode(wire, meta, extra_lead=0):
        plist = tree_lib.flatten_up_to(meta.treedef, wire)
        outs = [lc.decode(p, i, size, shape, dtype, extra_lead=extra_lead)
                for i, (p, (size, shape, dtype), lc) in
                enumerate(zip(plist, meta.infos, meta.extra))]
        return tree_lib.unflatten(meta.treedef, outs)

    def wire_bits(tree):
        leaves = tree_lib.leaves(tree)
        lcs = leaves_for(len(leaves))
        return sum(lc.wire_bits(base.leaf_size(x))
                   for x, lc in zip(leaves, lcs))

    def wire_bytes(wire, meta):
        plist = tree_lib.flatten_up_to(meta.treedef, wire)
        return sum(lc.wire_bytes(p, info[0])
                   for p, info, lc in zip(plist, meta.infos, meta.extra))

    probe = leaves_for(len(pipes) if pipes else 1)
    encode_ef = encode_ef_lanes = encode_lanes = decode_lanes = None
    if fused_ef and all(lc.fused_ef for lc in probe):
        def encode_ef(key, tree, meta, round_idx=0):
            leaves = tree_lib.flatten_up_to(meta.treedef, tree)
            keys = leaf_keys(key, len(leaves))
            pairs = [lc.encode_ef(x, i, round_idx, key=keys[..., i, :],
                                  residual_dtype=info[2])
                     for i, (x, lc, info) in
                     enumerate(zip(leaves, meta.extra, meta.infos))]
            wire = tree_lib.unflatten(meta.treedef, [p for p, _ in pairs])
            resid = tree_lib.unflatten(meta.treedef, [r for _, r in pairs])
            return wire, resid

    if all(getattr(lc, "lanes", False) for lc in probe):
        # encode and encode_ef take a stack of keys with a lane tree as they
        # are (leaf_keys keeps the lane axis); decode keeps it as extra_lead
        encode_lanes, encode_ef_lanes = encode, encode_ef

        def decode_lanes(wire, meta):
            return decode(wire, meta, extra_lead=1)

    return TreeCodec(name, encode, lambda wire, meta: decode(wire, meta),
                     meta, wire_bits, wire_bytes, rate=rate,
                     encode_ef=encode_ef, encode_lanes=encode_lanes,
                     encode_ef_lanes=encode_ef_lanes,
                     decode_lanes=decode_lanes)


# ---------------------------------------------------------------------------
# simulation-only wrapper: core.baselines compressors as one-stage pipelines
# ---------------------------------------------------------------------------
def sim_pipeline(comp) -> TreeCodec:
    """A `core.baselines.Compressor` as a degenerate single-stage pipeline
    (identity transform, quantize-only, no pack): the wire is the decoded
    tree itself (`sim_only=True`), with the compressor's analytic bits as
    both audit and ledger."""

    def encode(key, tree, round_idx=0):
        leaves, spec = tree_lib.flatten(tree)
        keys = rnd.fold_in(leaf_keys(key, len(leaves)), round_idx)
        outs = [comp.roundtrip(keys[i], x.to(torch.float32).reshape(-1))
                for i, x in enumerate(leaves)]
        return tree_lib.unflatten(spec, outs)

    def meta(tree):
        spec, infos = base.tree_meta(tree)
        return TreeMeta(spec, infos)

    def decode(wire, meta):
        return tree_lib.unflatten(meta.treedef, [
            y.reshape(shape).to(dtype) for y, (_, shape, dtype) in
            zip(tree_lib.flatten_up_to(meta.treedef, wire), meta.infos)])

    def wire_bits(tree):
        return sum(comp.wire_bits(base.leaf_size(x))
                   for x in tree_lib.leaves(tree))

    def wire_bytes(wire, meta):
        return sum(comp.wire_bits(size) for size, _, _ in meta.infos) / 8.0

    return TreeCodec(comp.name, encode, decode, meta, wire_bits, wire_bytes,
                     sim_only=True)
