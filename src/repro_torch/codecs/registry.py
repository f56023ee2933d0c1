"""Named codec factories over the stage pipelines (port of
`repro.codecs.registry`): one registry, one call convention.

    codec = registry.make("ndsc", budget=1.5, chunk=128)
    wire  = codec.encode(key, tree, round_idx)
    meta  = codec.meta(tree)
    tree' = codec.decode(wire, meta)
    bits  = codec.wire_bits(tree)                     # analytic audit
    bytes = codec.wire_bytes(wire, meta)              # realized ledger entry

Budgets are bits per ORIGINAL model dimension; for ndsc the budget maps
onto a `GradCompConfig` with `effective_bits == budget` exactly, so the
realized ledger matches the audit to the byte. A budget may also be a
per-leaf sequence. Every factory has the reference's signature, so
`codec_spec` gives the same tuple in both packages.

Wire codecs: `ndsc`, `ratq`, `sparsify_then_embed` (stage pipelines),
`dsc` (the dense per-leaf frame `core.coding.Codec`) and `identity`.
Simulation-only: `sign`, `ternary`, `qsgd`, `naive`, `dither`, `topk`,
`randk` (`core.baselines` as single-stage pipelines).
"""
from __future__ import annotations

import dataclasses
import difflib
import inspect
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import tree as tree_lib
from repro_torch.codecs import stages
from repro_torch.codecs.base import (TreeCodec, TreeMeta, total_dims,
                                     tree_meta)
from repro_torch.core import baselines as B
from repro_torch.core import frames as frames_lib
from repro_torch.core.coding import Codec, CodecConfig, Payload
from repro_torch.core.embeddings import EmbeddingSpec
from repro_torch.dist import gradcomp as G

_REGISTRY: dict = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def available() -> tuple:
    return tuple(sorted(_REGISTRY))


def _unknown_name_error(name) -> ValueError:
    """List what IS registered and the nearest spelling."""
    names = available()
    close = difflib.get_close_matches(str(name), names, n=1)
    hint = f"; did you mean {close[0]!r}?" if close else ""
    return ValueError(f"unknown codec {name!r}{hint} "
                      f"(available: {', '.join(names)})")


def codec_spec(name: str, budget, kwargs: dict) -> tuple:
    """The hashable identity of a `make` call: (name, budget, kwargs
    canonicalized against the factory's signature). Equal specs build
    codecs that encode and decode identically, so the fed engine uses the
    spec as its cohort key."""
    if name not in _REGISTRY:
        raise _unknown_name_error(name)
    sig = inspect.signature(_REGISTRY[name])
    params = list(sig.parameters.values())
    bound = sig.bind(budget, **kwargs)
    bound.apply_defaults()
    budget_val = bound.arguments[params[0].name]
    items: dict = {}
    for p in params[1:]:
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            items.update(bound.arguments.get(p.name, {}))
        else:
            items[p.name] = bound.arguments[p.name]
    budget_key = (float(budget_val) if np.isscalar(budget_val)
                  else tuple(float(b) for b in budget_val))
    return (name, budget_key, tuple(sorted(items.items())))


_UNSET = object()


def make(name, budget=_UNSET, **kwargs) -> TreeCodec:
    """Instantiate a registered compressor at a bits-per-dimension budget:
    `make("ndsc", 1.5, chunk=64)`, or `make(spec)` with the canonical
    tuple of `codec_spec` (carried on every codec as `TreeCodec.spec`);
    `make(c.spec).spec == c.spec` for every codec c."""
    if isinstance(name, (tuple, list)):
        if budget is not _UNSET or kwargs:
            raise ValueError("make(spec) takes no extra arguments: the "
                             "budget and kwargs are part of the spec")
        try:
            name, budget, items = name
            kwargs = dict(items)
        except (TypeError, ValueError):
            raise ValueError(f"malformed codec spec {name!r}; expected "
                             "(name, budget, kwargs_items) from codec_spec")
        if isinstance(budget, tuple):       # per-leaf budgets
            budget = list(budget)
    elif budget is _UNSET:
        budget = 4.0
    if name not in _REGISTRY:
        raise _unknown_name_error(name)
    codec = _REGISTRY[name](budget, **kwargs)
    return dataclasses.replace(codec, spec=codec_spec(name, budget, kwargs))


# ---------------------------------------------------------------------------
# identity — the no-compression reference (f32 wire)
# ---------------------------------------------------------------------------
@register("identity")
def _identity(budget: float = 32.0, **_) -> TreeCodec:
    def encode(key, tree, round_idx=0):
        return tree_lib.map(lambda x: x.to(torch.float32), tree)

    def decode(wire, meta):
        return tree_lib.unflatten(meta.treedef, [
            x.to(info[2]) for x, info in
            zip(tree_lib.flatten_up_to(meta.treedef, wire), meta.infos)])

    def meta(tree):
        spec, infos = tree_meta(tree)
        return TreeMeta(spec, infos)

    return TreeCodec(
        "identity", encode, decode, meta,
        wire_bits=lambda tree: 32.0 * total_dims(tree),
        wire_bytes=lambda wire, meta: 4.0 * sum(i[0] for i in meta.infos),
        rate=32.0)


# ---------------------------------------------------------------------------
# ndsc — the chunked Hadamard-frame pipeline (fused gradcomp stage impl)
# ---------------------------------------------------------------------------
def gradcomp_config_for_budget(budget: float, chunk: int = 128,
                               dithered: bool = False, exact_keep: bool = True,
                               seed: int = 0) -> G.GradCompConfig:
    """A fractional bits/dim budget as a GradCompConfig with
    `effective_bits == budget`: the smallest packable word size covering
    the budget, with a chunk keep-fraction making up the fractional part."""
    if not 0.0 < budget <= 8.0:
        raise ValueError(f"ndsc budget must be in (0, 8], got {budget}")
    bits = next(b for b in (1, 2, 4, 8) if b >= budget)
    return G.GradCompConfig(
        bits=bits, chunk=chunk, keep_fraction=min(budget / bits, 1.0),
        exact_keep=exact_keep, dithered=dithered,
        error_feedback=not dithered, seed=seed)


def _chunked_pipeline(cfg: G.GradCompConfig,
                      quantize_kind: Optional[str] = None,
                      ladder: int = 16) -> stages.Pipeline:
    """The stage-pipeline spelling of a GradCompConfig (+ quantizer choice)."""
    if cfg.keep_fraction < 1.0:
        sparsify = stages.Sparsify(
            "chunk_drop", fraction=cfg.keep_fraction, exact=cfg.exact_keep,
            rescale=cfg.dithered and not cfg.error_feedback)
    else:
        sparsify = stages.Sparsify("none")
    kind = quantize_kind or ("dithered" if cfg.dithered else "uniform")
    return stages.Pipeline(
        transform=stages.Transform("hadamard", seed=cfg.seed),
        sparsify=sparsify,
        quantize=stages.Quantize(kind, bits=cfg.bits, ladder=ladder),
        pack=stages.Pack("int32"), chunk=cfg.chunk)


@register("ndsc")
def _ndsc(budget, *, chunk: int = 128, dithered: bool = False,
          exact_keep: bool = True, seed: int = 0) -> TreeCodec:
    def pipeline_for(b: float) -> stages.Pipeline:
        return _chunked_pipeline(
            gradcomp_config_for_budget(b, chunk, dithered, exact_keep, seed))

    if np.isscalar(budget):
        rate = gradcomp_config_for_budget(budget, chunk).effective_bits
        return stages.tree_codec(f"ndsc(R={budget:g})", pipeline_for(budget),
                                 rate=rate)
    budgets = list(budget)
    tag = f"ndsc(R per leaf={[round(float(b), 3) for b in budgets]})"
    return stages.tree_codec(tag, [pipeline_for(b) for b in budgets])


# ---------------------------------------------------------------------------
# ratq — adaptive fixed-length quantizer baseline (Mayekar & Tyagi)
# ---------------------------------------------------------------------------
@register("ratq")
def _ratq(budget, *, chunk: int = 128, ladder: int = 16,
          exact_keep: bool = True, seed: int = 0) -> TreeCodec:
    """RATQ at a bits/dim budget: ndsc's bits × keep-fraction split, with a
    ⌈log2 ladder⌉-bit rung per chunk in place of the f32 scale."""
    if not np.isscalar(budget):
        raise ValueError("ratq takes a scalar bits/dim budget")
    cfg = gradcomp_config_for_budget(float(budget), chunk,
                                     exact_keep=exact_keep, seed=seed)
    pipeline = _chunked_pipeline(cfg, quantize_kind="ratq", ladder=ladder)
    return stages.tree_codec(f"ratq(R={budget:g},h={ladder})", pipeline,
                             rate=cfg.effective_bits)


# ---------------------------------------------------------------------------
# sparsify_then_embed — top-k/rand-k survivors, democratically embedded
# ---------------------------------------------------------------------------
@register("sparsify_then_embed")
def _sparsify_then_embed(budget, *, mode: str = "topk", bits: int = 4,
                         chunk: int = 128, dithered: bool = False,
                         k_fraction: Optional[float] = None,
                         seed: int = 0) -> TreeCodec:
    """Keep `k_fraction·n` coordinates in original space (top-k by
    magnitude, or a shared random-k subset), then NDSC-encode them; by
    default k = budget/bits · n, with log2 C(n,k) index bits on top."""
    if mode not in ("topk", "randk"):
        raise ValueError(f"mode must be 'topk' or 'randk', got {mode!r}")
    kf = min(1.0, float(budget) / bits) if k_fraction is None else k_fraction
    kf = min(max(kf, 1e-4), 1.0)
    pipeline = stages.Pipeline(
        transform=stages.Transform("hadamard", seed=seed),
        sparsify=stages.Sparsify(mode, fraction=kf),
        quantize=stages.Quantize("dithered" if dithered else "uniform",
                                 bits=bits),
        pack=stages.Pack("int32"), chunk=chunk)
    return stages.tree_codec(
        f"sparsify_then_embed({mode},R={budget:g})", pipeline)


# ---------------------------------------------------------------------------
# dsc — the dense frame Codec from core.coding (per-leaf Hadamard frames)
# ---------------------------------------------------------------------------
@register("dsc")
def _dsc(budget, *, dithered: bool = False, embedding: str = "near_democratic",
         seed: int = 0) -> TreeCodec:
    """One Hadamard frame per leaf (N the next power of two of its size),
    whose encode (Sᵀ y) and decode (S x) run one FWHT of N each: on the
    card above N = 8192 the FWHT's passes (a full-width yi-6b leaf takes
    N up to 2^28)."""
    codec_cache: dict = {}

    def codec_for(leaf_idx: int, n: int, device) -> Codec:
        k = (leaf_idx, n, torch.device(device))
        if k not in codec_cache:
            key = rnd.fold_in(rnd.key(seed, device=device), leaf_idx)
            frame = frames_lib.hadamard_frame(key, n)
            codec_cache[k] = Codec(frame, CodecConfig(
                bits_per_dim=float(budget), dithered=dithered,
                embedding=EmbeddingSpec(kind=embedding)))
        return codec_cache[k]

    def encode(key, tree, round_idx=0):
        leaves, spec = tree_lib.flatten(tree)
        keys = rnd.fold_in(stages.leaf_keys(key, len(leaves)), round_idx)
        outs = []
        for i, x in enumerate(leaves):
            c = codec_for(i, x.numel(), x.device)
            p = c.encode(x.to(torch.float32).reshape(-1), keys[i])
            outs.append({"indices": p.indices, "scale": p.scale}
                        | ({"mask": p.mask} if p.mask is not None else {}))
        return tree_lib.unflatten(spec, outs)

    def meta(tree):
        spec, infos = tree_meta(tree)
        return TreeMeta(spec, infos)

    def decode(wire, meta):
        plist = tree_lib.flatten_up_to(meta.treedef, wire)
        outs = []
        for i, (p, (size, shape, dtype)) in enumerate(zip(plist, meta.infos)):
            c = codec_for(i, size, p["indices"].device)
            y = c.decode(Payload(p["indices"], p["scale"], p.get("mask")))
            outs.append(y.reshape(shape).to(dtype))
        return tree_lib.unflatten(meta.treedef, outs)

    def wire_bits(tree):
        return sum(codec_for(i, x.numel(), x.device).wire_bits() + 32.0
                   for i, x in enumerate(tree_lib.leaves(tree)))

    def wire_bytes(wire, meta):
        total = 0.0
        for i, (p, (size, _, _)) in enumerate(zip(
                tree_lib.flatten_up_to(meta.treedef, wire), meta.infos)):
            c = codec_for(i, size, p["indices"].device)
            per_idx = 1.0 if c.sublinear else math.log2(c.levels)
            if "mask" in p:
                # the keep mask is NOT charged: the decoder regenerates it
                # from the shared key (as Codec.wire_bits counts kept
                # coordinates only)
                total += float(p["mask"].sum()) * per_idx / 8.0 + 4.0
                continue
            total += (c.N * per_idx) / 8.0 + 4.0
        return total

    return TreeCodec(f"dsc(R={budget:g})", encode, decode, meta,
                     wire_bits, wire_bytes, rate=float(budget))


# ---------------------------------------------------------------------------
# core.baselines — simulation-only single-stage pipelines
# ---------------------------------------------------------------------------
@register("sign")
def _sign(budget=1.0, *, scaled: bool = True, **_) -> TreeCodec:
    return stages.sim_pipeline(B.sign_compressor(scaled))


@register("ternary")
def _ternary(budget=math.log2(3), **_) -> TreeCodec:
    return stages.sim_pipeline(B.ternary())


@register("qsgd")
def _qsgd(budget=4.0, **_) -> TreeCodec:
    # n(1 + log2(s+1)) + 32 bits: sign + stochastic level index per coord
    s = max(1, int(round(2.0 ** (budget - 1.0) - 1.0)))
    return stages.sim_pipeline(B.qsgd(s))


@register("naive")
def _naive(budget=4.0, **_) -> TreeCodec:
    levels = max(2, int(round(2.0 ** budget)))
    return stages.sim_pipeline(B.naive_uniform(levels))


@register("dither")
def _dither(budget=4.0, **_) -> TreeCodec:
    levels = max(2, int(round(2.0 ** budget)))
    return stages.sim_pipeline(B.standard_dither(levels))


@register("topk")
def _topk(budget=4.0, *, k_fraction: Optional[float] = None,
          quant_levels: Optional[int] = 256, **_) -> TreeCodec:
    per_val = 32.0 if quant_levels is None else math.log2(quant_levels)
    kf = budget / per_val if k_fraction is None else k_fraction
    return stages.sim_pipeline(B.topk(min(max(kf, 1e-4), 1.0), quant_levels))


@register("randk")
def _randk(budget=4.0, *, k_fraction: Optional[float] = None,
           quant_levels: Optional[int] = 256, unbiased: bool = False,
           **_) -> TreeCodec:
    per_val = 32.0 if quant_levels is None else math.log2(quant_levels)
    kf = budget / per_val if k_fraction is None else k_fraction
    return stages.sim_pipeline(
        B.randk(min(max(kf, 1e-4), 1.0), quant_levels, unbiased))
