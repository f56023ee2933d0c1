"""Transformer layer primitives (port of `repro.models.layers`): RMSNorm,
embedding, RoPE, blockwise (online-softmax) attention, single-token decode
attention against an f32 cache, SwiGLU, the GELU MLP and the chunked
cross-entropy; and the reference's `jax.nn.softplus` / `log_sigmoid`.
Written in plain torch ops with the reference's
shapes, padding and operation order; attention keeps the reference's
online softmax rather than calling `scaled_dot_product_attention`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Norms / embeddings
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight).to(dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          tp=None) -> torch.Tensor:
    """The lookup; with `tp` (a `dist.sharding.ModelShard`) `table` is
    this rank's vocab rows."""
    if tp is None:
        return torch.nn.functional.embedding(tokens, table)
    return tp.embed(tokens, table)


def linear(x: torch.Tensor, w: torch.Tensor, tp=None,
           name: str = "") -> torch.Tensor:
    """x @ w; with `tp`, x times the whole leaf `name` of which w is this
    rank's slice (`ModelShard.linear`)."""
    return x @ w if tp is None else tp.linear(x, w, name)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def yarn_range(head_dim: int, rope) -> tuple:
    """(low, high): the dim pairs between which YaRN's ramp runs, from the
    number of rotations β_fast and β_slow make over the original length
    (HF's `find_correction_range` with its default `truncate`: low
    floored, high ceiled), clamped to [0, head_dim − 1]."""
    def dim_of(rotations):
        return (head_dim * math.log(rope.original_max_position
                                    / (rotations * 2 * math.pi))
                / (2 * math.log(rope.theta)))

    low = math.floor(dim_of(rope.beta_fast))
    high = math.ceil(dim_of(rope.beta_slow))
    return max(low, 0), min(high, head_dim - 1)


def yarn_attention_factor(rope) -> float:
    """The factor YaRN multiplies cos and sin by: the given one, else
    0.1·ln(factor) + 1."""
    if rope.attention_factor is not None:
        return float(rope.attention_factor)
    return 0.1 * math.log(rope.factor) + 1.0 if rope.factor > 1 else 1.0


def rope_table(head_dim: int, rope, device=None) -> tuple:
    """(frequencies (dh/2,) f32, scale) of a layer's `RopeSpec`, computed
    in float64 and rounded once: the plain θ^(−2i/dh) and no scale; with
    YaRN (`rope.factor`), each frequency blended between f_i / factor
    (interpolated, below pair `low`) and f_i (kept, above `high`) by a
    linear ramp, as HF's `_compute_yarn_parameters` does, and the scale of
    `yarn_attention_factor`. Rounded once, the table is the formula's to
    half an ulp: at 8,192 positions an ulp of a frequency near 1 turns an
    angle by up to 5e-4 rad, which a power taken in f32 can."""
    f64 = torch.float64
    exps = torch.arange(0, head_dim, 2, dtype=f64, device=device) / head_dim
    freqs = 1.0 / torch.pow(
        torch.full((), rope.theta, dtype=f64, device=device), exps)
    if rope.factor is None:
        return freqs.to(torch.float32), None
    low, high = yarn_range(head_dim, rope)
    if low == high:
        high += 0.001                   # HF's guard against a zero width
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=f64,
                                     device=device) - low) / (high - low),
                       0.0, 1.0)
    blended = freqs / rope.factor * ramp + freqs * (1.0 - ramp)
    return blended.to(torch.float32), yarn_attention_factor(rope)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor,
               scale: Optional[float] = None) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) or (S,); `freqs` (dh/2,) the
    layer's table (`rope_table`). `scale` multiplies cos and sin (YaRN's
    attention factor: q·k then scales by its square)."""
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, dh/2)
    cos = torch.cos(angles)[..., None, :]                    # (B, S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    if scale is not None:
        cos, sin = cos * scale, sin * scale
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise attention (online softmax)
# ---------------------------------------------------------------------------
NEG_INF = -1e30
BLOCK_Q, BLOCK_KV = 512, 1024


def block_pairs(sq: int, skv: int, *, causal: bool,
                window: Optional[int] = None, block_q: int = BLOCK_Q,
                block_kv: int = BLOCK_KV) -> list:
    """Per query block, the kv blocks `blockwise_attention` computes: those
    in which some real query (position < sq) may see some real key
    (position < skv), query i seeing key j when j ≤ i (causal) and
    j > i − window (windowed). Decided from the static sizes alone, so a
    captured graph holds only these pairs. A skipped pair's scores are all
    masked: for every real query it would add exact zeros (after a pair
    that has a key) or be wiped by the first pair that has one (corr = 0),
    so skipping it leaves every real row's output as it was."""
    nq, nkv = -(-sq // block_q), -(-skv // block_kv)
    out = []
    for iq in range(nq):
        q_lo, q_hi = iq * block_q, min((iq + 1) * block_q, sq) - 1
        keep = []
        for ikv in range(nkv):
            kv_lo, kv_hi = ikv * block_kv, min((ikv + 1) * block_kv, skv) - 1
            if causal and kv_lo > q_hi:
                continue
            if window is not None and kv_hi <= q_lo - window:
                continue
            keep.append(ikv)
        out.append(keep)
    return out


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: Optional[int] = None,
                        block_q: int = BLOCK_Q,
                        block_kv: int = BLOCK_KV) -> torch.Tensor:
    """Online-softmax attention, GQA-native.

    q: (B, Sq, H, dh); k, v: (B, Skv, K, dh) with H % K == 0. Queries are
    grouped (B, K, G, bq, dh) so KV is never repeated; at most
    (block_q, block_kv) scores per head exist at a time. Of the (q, kv)
    block pairs only those `block_pairs` keeps are computed: a causal
    layer's upper triangle and a windowed layer's blocks behind its window
    are skipped."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = dh ** -0.5
    pad_q = (-sq) % block_q
    pad_kv = (-skv) % block_kv
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q)) if pad_q else q
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_kv)) if pad_kv else k
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_kv)) if pad_kv else v
    nq, nkv = qp.shape[1] // block_q, kp.shape[1] // block_kv

    qb = (qp.reshape(b, nq, block_q, kh, g, dh).permute(1, 0, 3, 4, 2, 5)
          * scale).to(torch.float32)              # (nq, B, K, G, bq, dh)
    kb = kp.reshape(b, nkv, block_kv, kh, dh).permute(1, 0, 3, 4, 2) \
        .to(torch.float32)                        # (nkv, B, K, dh, bkv)
    vb = vp.reshape(b, nkv, block_kv, kh, dh).permute(1, 0, 3, 2, 4) \
        .to(torch.float32)                        # (nkv, B, K, bkv, dh)

    dev = q.device
    outs = []
    pairs = block_pairs(sq, skv, causal=causal, window=window,
                        block_q=block_q, block_kv=block_kv)
    for iq in range(nq):
        qblk = qb[iq]
        q_pos = iq * block_q + torch.arange(block_q, device=dev)
        acc = torch.zeros((b, kh, g, block_q, dh), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, kh, g, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kh, g, block_q), dtype=torch.float32, device=dev)
        for ikv in pairs[iq]:
            kv_pos = ikv * block_kv + torch.arange(block_kv, device=dev)
            s = qblk @ kb[ikv][:, :, None]         # (B, K, G, bq, bkv)
            mask = kv_pos[None, :] < skv           # kv padding
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + p @ vb[ikv][:, :, None]
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs)                        # (nq, B, K, G, bq, dh)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * block_q, h, dh)
    return out[:, :sq].to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, kv_len: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a cache, GQA-native (the cache is
    read once, never repeated per query head). q: (B, 1, H, dh); caches:
    (B, S, K, dh); kv_len: (B,) number of valid positions."""
    b, _, h, dh = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, dh).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg,
                          k_cache.to(torch.float32)) * dh ** -0.5
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    valid = pos[None, :] < kv_len[:, None]
    if window is not None:
        valid = valid & (pos[None, :] >= (kv_len[:, None] - window))
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, tp=None) -> torch.Tensor:
    """(SiLU(x W_gate) ⊙ x W_up) W_down. With `tp` (a
    `dist.sharding.ModelShard`) the weights are this rank's slices: where
    d_ff is split (param_spec splits all three on d_ff, or none), a
    Megatron pair, the gate and up columns feeding their rows of W_down,
    whose partials one all-reduce sums."""
    y = (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
    return y if tp is None or tp.split("w_gate") is None else tp.reduce(y)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """(GELU(x W_up)) W_down, the GELU `jax.nn.gelu`'s default (the tanh
    approximation) in its op order."""
    u = x @ w_up
    cdf = 0.5 * (1.0 + torch.tanh(
        (2.0 / torch.pi) ** 0.5 * (u + 0.044715 * (u * (u * u)))))
    return (u * cdf) @ w_down


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0), not torch's thresholded
    `F.softplus`."""
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.log_sigmoid`: −softplus(−x)."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never materializes (B, S, V) logits)
# ---------------------------------------------------------------------------
def chunked_softmax_xent(h: torch.Tensor, head: torch.Tensor,
                         targets: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """h: (B, S, d); head: (d, V); targets: (B, S) int → mean CE over the
    targets ≥ 0, one (B, chunk, V) block of logits at a time."""
    b, s, d = h.shape
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], chunk):
        hh = h[:, c0:c0 + chunk]
        tt = targets[:, c0:c0 + chunk]
        logits = (hh @ head).to(torch.float32)             # (B, chunk, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp_min(tt, 0)[..., None].long())[..., 0]
        valid = (tt >= 0).to(torch.float32)
        total = total + torch.sum((lse - gold) * valid)
        count = count + torch.sum(valid)
    return total / torch.clamp_min(count, 1.0)
