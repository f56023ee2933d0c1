"""Decode (serving) path: one-token steps against explicit caches (port of
`repro.models.decode`).

Per-layer caches are stacked on a leading L axis, as in the reference; the
reference's `lax.scan` over (block params, block cache) is a Python loop
over the layers here. Cache kinds per block family:

  attention    — attn_mlp, attn_moe, attn_moe_dense and hybrid. Either
                 f32 "k", "v": (L, B, C, K, dh) in the compute dtype, or
                 with `cfg.kv_quant_bits` the NDSC cache "k_words" /
                 "v_words" (L, B, C, K, dh·bits/32) int32, "k_scale" /
                 "v_scale" (L, B, C, K) f32 and the per-layer rotation
                 "signs" (L, K, dh), written through `kvquant.encode_entry`
                 by prefill and decode alike (one wire format), read
                 through `kvquant.quant_decode_attention`. A sliding-window
                 cache is a ring of C = window slots (position p in slot
                 p % C).
  hybrid       — the KV ring cache + the Mamba state "ssm_h" (L, B, di, n).
  xlstm_pair   — the mLSTM state "m_c" (L, B, H, dh, dh), "m_n", "m_m"
                 and the sLSTM state "s_c", "s_n", "s_h" (L, B, d).
  moe          — the KV cache only (experts are stateless).
  encoder      — no decode (raises; callers consult cfg.decode_supported).

`pos` is a per-slot (B,) counter, so the continuous-batching engine
(`repro_torch.serve`) refills finished slots independently.

Unlike the reference, whose arrays are immutable, the caches are updated IN
PLACE: `decode_step` writes the new K/V and recurrent states into the
state's cache tensors and returns a state holding those same tensors (with
a new `pos`), and `scatter_slot` writes into the batched state it is given.
A state passed to either must not be read again as the old state.
`extract_slot` returns copies, so a prefix-cache entry never aliases a live
state.

The serve programs (`decode_step`, `prefill`, `decode_tokens`,
`prefill_into`, `extend_into`) can be captured as CUDA graphs
(`repro_torch.graph`): they read no tensor on the host, copy nothing from
it (the rotation signs are made once per shape and device, outside any
program) and index slots by a device tensor. `extract_slot` reads a
position on the host and stays outside every program.

Tensor parallelism over "model": `decode_step`'s `tp` (a
`dist.sharding.ModelShard`) says the params are this rank's slices, as
`param_specs` cut them. The embedding is vocab-row-split (each rank looks
up its rows, one all-reduce); q, k and v are gathered in one all-gather
(the caches are replicated over "model", so every rank writes the whole
new K/V entry, and every rank attends with all heads: the launches per
rank per step are one worker's, 1 quant_decode_attention, 2 quantize_pack
and 3 fwht per attention layer); wo and the MLP's W_down are row-split
(one all-reduce each, the MLP a Megatron pair); the head's vocab columns
are gathered. With `tp` None the path is the one-worker step, op for op.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.models import kvquant
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.model import ModelConfig, block_forward, layer_params


class DecodeState(NamedTuple):
    """Stacked per-layer caches + per-slot position counters."""

    caches: dict            # leaves with a leading (num_scanned,) axis
    pos: torch.Tensor       # (B,) int32 — tokens already in each slot


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------
def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    return cfg.decode_cache_len(max_seq)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=None, device=None) -> DecodeState:
    """Zero caches sized for decoding up to `max_seq` total positions, on
    `device` (`cuda` unless asked for the CPU)."""
    if not cfg.decode_supported:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    device = resolve_device(device)
    dt = dtype or cfg.compute_dtype
    f32 = torch.float32
    nl = cfg.num_scanned
    c = cache_len(cfg, max_seq)
    caches: dict = {}

    def zeros(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.block in ("attn_mlp", "attn_moe", "attn_moe_dense", "hybrid"):
        if cfg.kv_quant_bits:
            qc = kvquant.init_cache(nl, batch, c, cfg.num_kv_heads, cfg.dh,
                                    cfg.kv_quant_bits, device=device)
            caches.update(qc._asdict())
            caches["signs"] = _layer_signs(nl, cfg.num_kv_heads, cfg.dh,
                                           device).clone()
        else:
            for side in ("k", "v"):
                caches[side] = zeros((nl, batch, c, cfg.num_kv_heads,
                                      cfg.dh), dt)
    if cfg.block == "hybrid":
        caches["ssm_h"] = zeros((nl, batch, cfg.di, cfg.ssm_state))
    if cfg.block == "xlstm_pair":
        d, hh = cfg.d_model, cfg.num_heads
        dh = d // hh
        caches["m_c"] = zeros((nl, batch, hh, dh, dh))
        caches["m_n"] = zeros((nl, batch, hh, dh))
        caches["m_m"] = torch.full((nl, batch, hh), -1e30, dtype=f32,
                                   device=device)
        for name in ("s_c", "s_n", "s_h"):
            caches[name] = zeros((nl, batch, d))
    return DecodeState(caches=caches,
                       pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))


@functools.lru_cache(maxsize=None)
def _layer_signs(num_layers: int, num_kv: int, dh: int,
                 device: torch.device) -> torch.Tensor:
    """The per-layer rotation signs (L, K, dh), drawn once per shape and
    device: drawing them copies the threefry key from the host, which a
    captured program (`repro_torch.graph`) must not do. Each state gets a
    device copy of its own."""
    return torch.stack([kvquant.head_signs(0, layer, num_kv, dh,
                                           device=device)
                        for layer in range(num_layers)])


def decode_state_specs(cfg: ModelConfig, batch: int,
                       max_seq: int) -> DecodeState:
    """The state of `init_decode_state` as `meta` tensors (shapes, dtypes,
    no storage), the port's stand-in for the reference's
    ShapeDtypeStructs."""
    return init_decode_state(cfg, batch, max_seq, device="meta")


def _cache_len_of(state: DecodeState) -> int:
    """Positions in the attention cache; 0 for a family without one."""
    for key in ("k_words", "k"):
        if key in state.caches:
            return state.caches[key].shape[2]
    return 0


# ---------------------------------------------------------------------------
# One-layer decode
# ---------------------------------------------------------------------------
def _attn_decode(cfg: ModelConfig, p: dict, cache: dict, h: torch.Tensor,
                 pos: torch.Tensor, c: int, tp=None) -> torch.Tensor:
    """Self-attention for one new token against ONE layer's cache views
    `cache`, which it updates in place; returns the attention output."""
    b = h.shape[0]
    x = L.rmsnorm(h, p["attn_norm"], cfg.norm_eps)
    if tp is None:
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    else:
        q, k, v = tp.linears(x, [(p[n], n) for n in ("wq", "wk", "wv")])
    q = q.reshape(b, 1, cfg.num_heads, cfg.dh)
    k = k.reshape(b, 1, cfg.num_kv_heads, cfg.dh)
    v = v.reshape(b, 1, cfg.num_kv_heads, cfg.dh)
    positions = pos[:, None]                     # (B, 1) per-slot positions
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    rows = torch.arange(b, device=h.device)
    slot = torch.remainder(pos, c).long()        # (B,) ring slots
    kv_len = torch.clamp_max(pos + 1, c)         # (B,) valid lengths

    if cfg.kv_quant_bits:                        # NDSC-packed cache path
        bits = cfg.kv_quant_bits
        signs = cache["signs"]                   # (K, dh) — this layer's D
        for side, new in (("k", k), ("v", v)):
            words, scale = kvquant.encode_entry(new, signs, bits)
            cache[f"{side}_words"][rows, slot] = words[:, 0]
            cache[f"{side}_scale"][rows, slot] = scale[:, 0]
        o = kvquant.quant_decode_attention(
            q, (cache["k_words"], cache["k_scale"],
                cache["v_words"], cache["v_scale"]),
            kv_len, signs, bits)
    else:
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        o = L.decode_attention(q, cache["k"], cache["v"], kv_len=kv_len)
    return L.linear(o.reshape(b, 1, cfg.q_dim), p["wo"], tp, "wo")


def block_decode(cfg: ModelConfig, p: dict, cache: dict, h: torch.Tensor,
                 pos: torch.Tensor, c: int, tp=None) -> torch.Tensor:
    """One scanned unit, one token: h (B, 1, d) → h. `cache` holds this
    layer's cache views and is updated in place; `tp` as in
    `decode_step`."""
    if cfg.block in ("attn_mlp", "attn_moe", "attn_moe_dense"):
        h = h + _attn_decode(cfg, p, cache, h, pos, c, tp)
    if cfg.block == "hybrid":
        attn_out = _attn_decode(cfg, p, cache, h, pos, c, tp)
        x = L.rmsnorm(h, p["attn_norm"], cfg.norm_eps)
        mamba_out, ssm_h = ssm_lib.mamba_decode_step(p["mamba"], x,
                                                     cache["ssm_h"], tp)
        cache["ssm_h"].copy_(ssm_h)
        h = h + 0.5 * (attn_out + mamba_out)
    if cfg.block in ("attn_mlp", "hybrid"):
        x = L.rmsnorm(h, p["mlp_norm"], cfg.norm_eps)
        h = h + L.swiglu(x, p["w_gate"], p["w_up"], p["w_down"], tp)
    if cfg.block in ("attn_moe", "attn_moe_dense"):
        x = L.rmsnorm(h, p["moe_norm"], cfg.norm_eps)
        moe_out = moe_lib.moe_ffn(
            x, p["router"], p["e_gate"], p["e_up"], p["e_down"],
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, tp=tp)
        if cfg.block == "attn_moe_dense":
            xm = L.rmsnorm(h, p["mlp_norm"], cfg.norm_eps)
            moe_out = moe_out + L.swiglu(xm, p["w_gate"], p["w_up"],
                                         p["w_down"], tp)
        h = h + moe_out
    if cfg.block == "xlstm_pair":
        x = L.rmsnorm(h, p["m_norm"], cfg.norm_eps)
        m_state = xlstm_lib.MLSTMState(cache["m_c"], cache["m_n"],
                                       cache["m_m"])
        m_out, m_state = xlstm_lib.mlstm_decode_step(
            p["mlstm"], x, cfg.num_heads, m_state, tp)
        h = h + m_out
        x = L.rmsnorm(h, p["s_norm"], cfg.norm_eps)
        s_state = xlstm_lib.SLSTMState(cache["s_c"], cache["s_n"],
                                       cache["s_h"])
        s_out, s_state = xlstm_lib.slstm_decode_step(
            p["slstm"], x, cfg.num_heads, s_state, tp)
        h = h + s_out
        for name, new in zip(("m_c", "m_n", "m_m", "s_c", "s_n", "s_h"),
                             tuple(m_state) + tuple(s_state)):
            cache[name].copy_(new)
    return h


# The arguments a captured serve program binds by pointer (keystr prefixes
# of its argument tuple, see `repro_torch.graph.Program`): the parameters,
# and the caches of the batched state that decode_step, prefill_into and
# extend_into write in place.
IN_PLACE_ARGS = ("[0]", "[1].caches")


# ---------------------------------------------------------------------------
# Full-stack decode step
# ---------------------------------------------------------------------------
@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, state: DecodeState,
                tokens: torch.Tensor, tp=None):
    """tokens: (B, 1) int → (logits (B, padded_vocab) f32, new state). The
    caches of `state` are updated in place (see the module docstring).
    With `tp` (a `dist.sharding.ModelShard`), `params` are this rank's
    slices and the step runs as tensor parallelism over "model"."""
    if not cfg.decode_supported:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    h = L.embed(tokens, params["embed"], tp).to(cfg.compute_dtype)
    c = _cache_len_of(state)
    leaves, spec = tree_lib.flatten(params["blocks"])
    for i in range(cfg.num_scanned):
        layer_cache = {name: x[i] for name, x in state.caches.items()}
        h = block_decode(cfg, tree_lib.unflatten(spec, [x[i] for x in leaves]),
                         layer_cache, h, state.pos, c, tp)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.linear(h[:, 0], params["head"], tp,
                      "head").to(torch.float32)             # (B, V)
    return logits, DecodeState(caches=state.caches, pos=state.pos + 1)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next token (B, 1) int32; ties go to the first maximal index,
    as with jnp.argmax."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def decode_tokens(cfg: ModelConfig, params: dict, state: DecodeState,
                  tokens: torch.Tensor):
    """Feed a (B, S) block of KNOWN tokens through S decode steps: the
    continuation primitive behind prefix-cache admission (the same
    `decode_step` applications a cold admission runs). Returns (logits
    after the LAST token (B, V), state advanced by S)."""
    if tokens.dim() != 2 or tokens.shape[1] < 1:
        raise ValueError(f"decode_tokens needs (B, S>=1) tokens, "
                         f"got {tuple(tokens.shape)}")
    logits = None
    for t in range(tokens.shape[1]):
        logits, state = decode_step(cfg, params, state, tokens[:, t:t + 1])
    return logits, state


# ---------------------------------------------------------------------------
# Slot scatter / extract: the continuous-batching and prefix-cache primitives
# ---------------------------------------------------------------------------
# Cache leaves indexed (L, B, C, ...) by position along axis 2 — the leaves a
# prefix-cache entry trims to its own length. Everything else with a batch
# axis (the recurrent states "ssm_h", "m_*", "s_*") is per-slot but
# position-free; "signs" is the per-layer rotation shared by every slot.
POSITIONAL_CACHE_KEYS = frozenset(
    {"k", "v", "k_words", "k_scale", "v_words", "v_scale"})
SHARED_CACHE_KEYS = frozenset({"signs"})


def scatter_slot(batched: DecodeState, single: DecodeState,
                 slot) -> DecodeState:
    """Write the batch-1 `single` into slot `slot` of `batched`, in place.

    Positional leaves of `single` may be trimmed to a prefix length C' <= C
    (see `extract_slot`); the slot's remaining C - C' positions are zeroed,
    so the result is bitwise the state a fresh batch-1 prefill of the same
    tokens would produce — the prefix-cache bit-exactness contract.
    Per-slot, position-free leaves (recurrent states) are written whole.

    `slot` is an int or a 0-d integer tensor on the state's device (a
    captured program's traced slot): the write indexes by a device tensor
    either way, so a graph never bakes a slot in."""
    dev = batched.pos.device
    idx = (slot.reshape(1).to(torch.long) if isinstance(slot, torch.Tensor)
           else torch.full((1,), int(slot), dtype=torch.long, device=dev))
    for name, b in batched.caches.items():
        if name in SHARED_CACHE_KEYS:
            continue
        s = single.caches[name].to(b.dtype)
        if name in POSITIONAL_CACHE_KEYS and s.shape[2] < b.shape[2]:
            pad = s.new_zeros(s.shape[:2] + (b.shape[2] - s.shape[2],)
                              + s.shape[3:])
            s = torch.cat([s, pad], dim=2)
        b.index_copy_(1, idx, s)
    pos = batched.pos.clone()
    pos.index_copy_(0, idx, single.pos[:1])
    return DecodeState(caches=batched.caches, pos=pos)


def extract_slot(state: DecodeState, slot: int, *,
                 trim: bool = True) -> DecodeState:
    """Slot `slot` of a batched state as a batch-1 state of COPIES.

    With `trim` (the default) positional cache leaves keep only their
    occupied columns — min(pos, C) of them; ring caches past their window
    keep all C. Per-slot, position-free leaves are copied whole.
    `scatter_slot(init, extract_slot(st, i), j)` reproduces slot i of `st`
    bitwise in slot j (zeros elsewhere). The shared rotation signs are
    never written, so they are shared, not copied."""
    slot = int(slot)
    length = int(state.pos[slot])
    caches = {}
    for name, x in state.caches.items():
        if name in SHARED_CACHE_KEYS:
            caches[name] = x
            continue
        col = x[:, slot:slot + 1]
        if trim and name in POSITIONAL_CACHE_KEYS:
            col = col[:, :, :min(length, x.shape[2])]
        caches[name] = col.clone()
    return DecodeState(caches=caches, pos=state.pos[slot:slot + 1].clone())


def expand_state(cfg: ModelConfig, single: DecodeState,
                 max_seq: int) -> DecodeState:
    """Inverse of `extract_slot`'s trim: a (possibly trimmed) batch-1 state
    re-seated in fresh full-size caches for decoding up to `max_seq`."""
    fresh = init_decode_state(cfg, 1, max_seq, device=single.pos.device)
    return scatter_slot(fresh, single, 0)


def prefill_into(cfg: ModelConfig, params: dict, batched: DecodeState,
                 tokens: torch.Tensor, slot, max_seq: int):
    """Cold admission: batch-1 prefill of `tokens` (S,) scattered into slot
    `slot` (an int or a 0-d tensor) of `batched`. Returns (new batched
    state, last-token logits (V,))."""
    logits, single = prefill(cfg, params, tokens[None, :], max_seq)
    return scatter_slot(batched, single, slot), logits[0]


def extend_into(cfg: ModelConfig, params: dict, batched: DecodeState,
                entry: DecodeState, tokens: torch.Tensor, slot,
                max_seq: int):
    """Prefix admission: re-seat the (trimmed) batch-1 `entry` in fresh
    full-size caches, decode the (S,) prompt continuation, and scatter the
    result into slot `slot` of `batched`. `entry` is only read. Returns
    (new batched state, last-token logits (V,))."""
    single = expand_state(cfg, entry, max_seq)
    logits, single = decode_tokens(cfg, params, single, tokens[None, :])
    return scatter_slot(batched, single, slot), logits[0]


def state_bytes(state: DecodeState) -> int:
    """Device bytes held by the per-slot leaves of `state` (shared leaves —
    the rotation signs — excluded): what a prefix-cache hit avoids
    recomputing and rewriting."""
    total = state.pos.numel() * state.pos.element_size()
    for name, x in state.caches.items():
        if name not in SHARED_CACHE_KEYS:
            total += x.numel() * x.element_size()
    return int(total)


# ---------------------------------------------------------------------------
# Prefill: run the training forward once, collect the caches
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_seq: int):
    """tokens: (B, S) prompt → (last-token logits (B, V), DecodeState at S).

    The attention families run the blockwise forward with `collect_kv`;
    when S exceeds the cache (a sliding-window ring) only the last C
    positions are written, at ring slots position % C, matching
    decode_step's insert rule. The quantized cache is written through the
    same `kvquant.encode_entry` as decode. The recurrent families (hybrid,
    xlstm_pair) step `decode_step` token by token, as the reference does,
    which keeps the prefix contract structural."""
    if not cfg.decode_supported:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    dev = tokens.device
    b, s = tokens.shape
    state = init_decode_state(cfg, b, max_seq, device=dev)
    if cfg.block not in ("attn_mlp", "attn_moe", "attn_moe_dense"):
        logits = None
        for t in range(s):
            logits, state = decode_step(cfg, params, state,
                                        tokens[:, t:t + 1])
        return logits, state

    c = cache_len(cfg, max_seq)
    h = L.embed(tokens, params["embed"]).to(cfg.compute_dtype)
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    if s <= c:
        ring_slots = torch.arange(s, device=dev)           # contiguous
    else:  # ring: the last c positions land at slots (s-c+i) % c
        ring_slots = torch.remainder(torch.arange(s - c, s, device=dev), c)

    caches = state.caches
    for i in range(cfg.num_scanned):
        h, _, (k, v) = block_forward(cfg, layer_params(params, i), h,
                                     positions, collect_kv=True)
        if s > c:
            k, v = k[:, s - c:], v[:, s - c:]
        if cfg.kv_quant_bits:
            for side, val in (("k", k), ("v", v)):
                words, scale = kvquant.encode_entry(val, caches["signs"][i],
                                                    cfg.kv_quant_bits)
                caches[f"{side}_words"][i][:, ring_slots] = words
                caches[f"{side}_scale"][i][:, ring_slots] = scale
        else:
            caches["k"][i][:, ring_slots] = k.to(caches["k"].dtype)
            caches["v"][i][:, ring_slots] = v.to(caches["v"].dtype)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = (h[:, -1] @ params["head"]).to(torch.float32)
    return logits, DecodeState(caches=caches,
                               pos=torch.full((b,), s, dtype=torch.int32,
                                              device=dev))
