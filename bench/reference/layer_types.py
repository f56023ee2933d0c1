"""Plain reference of a decoder whose layers differ in their attention, as
Mellum2-12B-A2.5B has them (https://huggingface.co/JetBrains/Mellum2-12B-
A2.5B-Instruct, config.json), in float32 PyTorch. No kernels, no cache,
no online softmax, no block skipping.

Layer ℓ, pre-norm, of type t(ℓ) ∈ {sliding, full} (`layer_types`):

    x = RMSNorm(h);  q = x Wq, k = x Wk, v = x Wv   (GQA: H query heads,
                                                     K key/value heads)
    q, k ← RoPE_t(q), RoPE_t(k)
    s_ij = q_i · k_j / √dh  for allowed j: j ≤ i, and on a sliding layer
                            also j > i − W
    h ← h + (Σ_j softmax_j(s_ij) v_j) Wo
    h ← h + MoE(RMSNorm(h))
    loss = CE(RMSNorm(h) W_head) + coef · Σ_ℓ aux_ℓ

RoPE_t rotates each head's halves (the rotate-half form) by angles p·f_i,
i < dh/2, with cos and sin multiplied by the type's attention factor a.
The plain table (rope_type "default") is f_i = θ^(−2i/dh), a = 1. YaRN
(rope_type "yarn", HF's `_compute_yarn_parameters`):
    low, high = ⌊d(β_fast)⌋, ⌈d(β_slow)⌉,  d(β) = dh·ln(L₀ / (2πβ)) / (2 ln θ)
    γ_i = clamp((i − low) / (high − low), 0, 1)
    f_i = γ_i · θ^(−2i/dh) / factor + (1 − γ_i) · θ^(−2i/dh)
with L₀ `original_max_position_embeddings` and a `attention_factor`, so
q·k scales by a². The table is built in float64 from these formulas and
held in float32, and the angles are taken in float32, as HF's forward
takes them.

RMSNorm and SwiGLU are `bench.reference.model`'s, and the MoE follows
its rules (softmax router, each token's top-k experts renormalized, at
most C = ⌊cf·T·k/E⌋ assignments an expert in token order, Switch's
load-balance term on the first choices), with one addition: a run can
follow another run's expert choices (`Routes`). The choices are
discrete, so a last-bit difference upstream flips a token's k-th expert
where its k-th and (k+1)-th probabilities nearly tie, and at this
model's random initialisation (routing far from balanced: many experts
past capacity) one flip also moves which later token an expert drops;
one such event in a step moves the loss and every gradient as much as
TF32 products do. So the comparison follows the program's choices and
checks them instead: the capacity rule applied to the followed choices
must keep exactly the assignments the program kept, and in the first
step, where both route from the same weights, wherever this reference
would choose another top-k set its k-th and (k+1)-th probabilities must
lie within `NEAR_TIE` (a flip it follows); any other difference is a
routing fault. In later steps the two runs' routers differ by the
updates the codec's last bits moved, so a flip is no longer a near-tie;
there the reference counts the top-k sets it follows that are not its
own (`Routes.flips`), and the cell bounds that count a step.

Attention is computed a block of `QUERY_BLOCK` queries at a time against
the keys any of them may see (for a sliding layer, from W − 1 before the
block's first query), as one masked softmax over those keys; each layer
runs under `torch.utils.checkpoint`, so that a sequence of 8,192
positions fits beside the weights.

Departures from the published model, as the configuration file states
them: float32 in place of bfloat16; capacity dispatch (the published
model is dropless); the router's aux coefficient assumed; no
multi-token-prediction head (its config has no key for it).

`loss(cfg, params, tokens, matmul, routes)` takes the configuration
file's keys (`layer_types`, `sliding_window`, `rope_parameters`) and the
weights
view of `bench.train_layer_types.weights_cfg` (the MoE's width under
`intermediate_size`, the experts under `num_local_experts`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import model

QUERY_BLOCK = 512
# the largest gap between a token's k-th and (k+1)-th router probability
# (of ~1/64 each) at which another run's top-k set is taken as a flip:
# 100x what the program's last-bit differences move a probability by
NEAR_TIE = 1e-6


class Routes:
    """One step's expert choices by layer: `forced` None records each
    layer's own (choice (T, k), kept (T·k,)); else each layer follows
    forced[i] and checks it (module docstring): the kept assignments
    always, the choices where `strict`, that is where both runs route
    from the same weights (the first step: later, AdamW's first ±lr
    updates wherever the codec's last bit flipped a code move the two
    runs' routers by more than a near-tie). Indexed by layer, so the
    recomputation under checkpoint in the backward finds the same
    entry."""

    def __init__(self, forced=None, strict: bool = True):
        self.forced = forced
        self.strict = strict
        self.recorded = {}
        self.flips = {}
        self.faults = {}

    def take(self, layer: int, probs: torch.Tensor, k: int,
             capacity: int) -> tuple:
        """(choice (T, k), kept (T·k,)) layer `layer` follows."""
        order = torch.sort(probs, dim=-1, descending=True,
                           stable=True).indices
        own = order[:, :k]
        if self.forced is None:
            kept = _kept(own, probs.shape[-1], capacity)
            self.recorded[layer] = (own, kept)
            return own, kept
        choice, program_kept = self.forced[layer]
        mine = torch.zeros_like(probs, dtype=torch.bool).scatter_(
            1, own, True)
        theirs = torch.zeros_like(probs, dtype=torch.bool).scatter_(
            1, choice, True)
        moved = (mine != theirs).any(-1)
        edge = torch.gather(probs, 1, order[:, k - 1:k + 1])
        tie = (edge[:, 0] - edge[:, 1]) <= NEAR_TIE
        kept = _kept(choice, probs.shape[-1], capacity)
        self.flips[layer] = int(moved.sum())
        self.faults[layer] = int((kept != program_kept).sum())
        if self.strict:
            self.faults[layer] += int((moved & ~tie).sum())
        return choice, kept


def _kept(choice: torch.Tensor, e: int, capacity: int) -> torch.Tensor:
    """Which of the (T·k,) assignments, in token order, are among the
    first `capacity` of their expert's."""
    flat = choice.reshape(-1)
    kept = torch.zeros_like(flat, dtype=torch.bool)
    for j in range(e):
        kept[torch.nonzero(flat == j).reshape(-1)[:capacity]] = True
    return kept


def moe(cfg, p, x, matmul, layer: int, routes: Routes):
    """Returns (output, load-balance term), the experts of
    `routes.take`."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    flat = x.reshape(t, d)
    probs = torch.softmax(matmul(flat, p["router"]), dim=-1)
    capacity = max(1, int(cfg["capacity_factor"] * t * k / e))
    choice, kept = routes.take(layer, probs.detach(), k, capacity)
    weight = torch.gather(probs, 1, choice)
    weight = weight / weight.sum(-1, keepdim=True)
    out = torch.zeros_like(flat)
    flat_choice = choice.reshape(-1)
    for j in range(e):
        hits = torch.nonzero((flat_choice == j) & kept).reshape(-1)
        tok, slot = hits // k, hits % k
        y = model.swiglu(flat[tok], p["e_gate"][j], p["e_up"][j],
                         p["e_down"][j], matmul)
        out = out.index_add(0, tok, y * weight[tok, slot][:, None])
    first = F.one_hot(choice[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.sum(first * probs.mean(0))
    return out.reshape(b, s, d), aux


def layer_kinds(cfg: dict) -> list:
    """"sliding" or "full" for each of the file's first
    `num_hidden_layers` layers."""
    kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
    return [k.replace("_attention", "") for k in kinds]


def rope_table(cfg: dict, kind: str) -> tuple:
    """(frequencies as float64 (dh/2,), attention factor) of a layer type."""
    spec = cfg["rope_parameters"][f"{kind}_attention"]
    dh = cfg["head_dim"]
    theta = float(spec["rope_theta"])
    i = torch.arange(dh // 2, dtype=torch.float64)
    f = theta ** (-2.0 * i / dh)
    if spec.get("rope_type", "default") == "default":
        return f, 1.0
    factor = float(spec["factor"])
    length = float(spec["original_max_position_embeddings"])

    def d(rotations):
        return dh * math.log(length / (2 * math.pi * rotations)) \
            / (2 * math.log(theta))

    low = max(math.floor(d(spec.get("beta_fast", 32))), 0)
    high = min(math.ceil(d(spec.get("beta_slow", 1))), dh - 1)
    gamma = torch.clamp((i - low) / max(high - low, 1e-3), 0.0, 1.0)
    factor_a = spec.get("attention_factor")
    if factor_a is None:
        factor_a = 0.1 * math.log(factor) + 1.0
    return gamma * f / factor + (1.0 - gamma) * f, float(factor_a)


def rope(x: torch.Tensor, freqs: torch.Tensor, factor: float):
    """x: (B, S, heads, dh), positions 0..S−1."""
    s, dh = x.shape[1], x.shape[-1]
    f32 = freqs.to(device=x.device, dtype=torch.float32)
    pos = torch.arange(s, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * f32[None, :]
    cos = (torch.cos(ang) * factor)[None, :, None]
    sin = (torch.sin(ang) * factor)[None, :, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(cfg, kind, p, x, matmul):
    b, s, _ = x.shape
    heads, kvh, dh = (cfg["num_attention_heads"],
                      cfg["num_key_value_heads"], cfg["head_dim"])
    q = matmul(x, p["wq"]).reshape(b, s, heads, dh)
    k = matmul(x, p["wk"]).reshape(b, s, kvh, dh)
    v = matmul(x, p["wv"]).reshape(b, s, kvh, dh)
    freqs, factor = rope_table(cfg, kind)
    q, k = rope(q, freqs, factor), rope(k, freqs, factor)
    k = k.repeat_interleave(heads // kvh, dim=2).transpose(1, 2)
    v = v.repeat_interleave(heads // kvh, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)                                # (B, H, S, dh)
    window = cfg["sliding_window"] if kind == "sliding" else None
    outs = []
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, s)
        first = 0 if window is None else max(0, lo - window + 1)
        qi = torch.arange(lo, hi, device=x.device)[:, None]
        kj = torch.arange(first, hi, device=x.device)[None, :]
        allowed = kj <= qi
        if window is not None:
            allowed = allowed & (kj > qi - window)
        scores = matmul(q[:, :, lo:hi], k[:, :, first:hi].transpose(2, 3)) \
            * dh ** -0.5
        scores = scores.masked_fill(~allowed, float("-inf"))
        outs.append(matmul(torch.softmax(scores, dim=-1), v[:, :, first:hi]))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, heads * dh)
    return matmul(o, p["wo"])


def layer(cfg, i, kind, p, h, matmul, routes):
    eps = cfg["rms_norm_eps"]
    h = h + attention(cfg, kind, p, model.rmsnorm(h, p["attn_norm"], eps),
                      matmul)
    y, aux = moe(cfg, p, model.rmsnorm(h, p["moe_norm"], eps), matmul, i,
                 routes)
    return h + y, aux


def loss(cfg, params, tokens, matmul=model._f32_matmul, routes=None):
    """Mean next-token cross-entropy of tokens (B, S + 1) plus the router's
    load-balance terms; the experts of `routes` (by default its own)."""
    routes = Routes() if routes is None else routes
    inputs, targets = tokens[:, :-1].long(), tokens[:, 1:].long()
    h = params["embed"][inputs]
    aux = torch.zeros((), device=h.device)
    blocks = params["blocks"]
    for i, kind in enumerate(layer_kinds(cfg)):
        p = {n: w[i] for n, w in blocks.items()}
        h, a = checkpoint(lambda hh, pp, ii=i, kk=kind: layer(
            cfg, ii, kk, pp, hh, matmul, routes), h, p, use_reentrant=False)
        aux = aux + a
    h = model.rmsnorm(h, params["final_norm"], cfg["rms_norm_eps"])
    logits = matmul(h, params["head"])
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1))
    return ce + cfg.get("router_aux_loss_coef", 0.0) * aux
