"""Plain reference of the decoder LMs the configurations name, in float32
PyTorch: Yi (arXiv:2403.04652, the Llama layout) and Mixtral
(arXiv:2401.04088). No kernels, no cache, no remat, no batching tricks.

A layer is pre-norm: h += Attn(RMSNorm(h)), then h += FFN(RMSNorm(h)).
Attention is grouped-query with rotary positions (the rotate-half form
over dh/2 frequencies θ^(−2i/dh)), a causal mask (and a window, where the
file sets `sliding_window`), softmax in f32. The FFN is SwiGLU; for a
mixture of experts the router's softmax picks each token's top-k experts
(ties to the lower index), their weights renormalized to sum to one.

One departure from the published Mixtral, which the program makes and
the configuration file states under `assumed`: each expert takes at most
C = max(1, ⌊capacity_factor · T · k / E⌋) of a batch's T·k assignments,
counted in token order (a token's first choice before its second), and
an assignment past C is dropped (it adds nothing). The loss adds
`router_aux_loss_coef` times the Switch load-balance term E·Σ_e f_e·p_e,
f_e the share of tokens whose first choice is e, p_e the mean router
probability of e, summed over the layers.

Parameters are the benchmark's tree (`bench.weights`): `blocks` holds each
weight stacked over the layers (wq (L, d, H·dh), ...), then `embed`,
`final_norm` and `head`. `matmul` is the one product every weight goes
through, so that a control can run the same arithmetic at a lower
precision.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties to even), its
    gradient passed straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    keep = bits + 0xFFF + ((bits >> 13) & 1)
    rounded = (keep & ~0x1FFF).view(torch.float32)
    return x + (rounded - x.detach())


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product with both operands rounded to TF32, accumulated in
    f32: what the card's TF32 tensor cores compute. Used where the card
    cannot be asked for them (the CPU)."""
    return _to_tf32(a) @ _to_tf32(b)


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x: (B, S, heads, dh), positions 0..S−1."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                       device=x.device) / dh)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None]
           * inv[None, :]).to(torch.float32)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(cfg, p, x, matmul):
    b, s, d = x.shape
    heads, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // heads
    q = matmul(x, p["wq"]).reshape(b, s, heads, dh)
    k = matmul(x, p["wk"]).reshape(b, s, kvh, dh)
    v = matmul(x, p["wv"]).reshape(b, s, kvh, dh)
    theta = float(cfg["rope_theta"])
    q, k = rope(q, theta), rope(k, theta)
    g = heads // kvh
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * dh ** -0.5
    pos = torch.arange(s, device=x.device)
    allowed = pos[None, :] <= pos[:, None]
    window = cfg.get("sliding_window")
    if window:
        allowed = allowed & (pos[None, :] > pos[:, None] - window)
    scores = scores.masked_fill(~allowed, float("-inf"))
    o = matmul(torch.softmax(scores, dim=-1), v.transpose(1, 2))
    return matmul(o.transpose(1, 2).reshape(b, s, heads * dh), p["wo"])


def swiglu(x, w_gate, w_up, w_down, matmul):
    return matmul(F.silu(matmul(x, w_gate)) * matmul(x, w_up), w_down)


def moe(cfg, p, x, matmul):
    """Returns (output, load-balance term)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    flat = x.reshape(t, d)
    probs = torch.softmax(matmul(flat, p["router"]), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    choice = order[:, :k]                                   # (T, k)
    weight = torch.gather(probs, 1, choice)
    weight = weight / weight.sum(-1, keepdim=True)
    capacity = max(1, int(cfg["capacity_factor"] * t * k / e))
    out = torch.zeros_like(flat)
    flat_choice = choice.reshape(-1)                        # token order
    for j in range(e):
        hits = torch.nonzero(flat_choice == j).reshape(-1)[:capacity]
        tok, slot = hits // k, hits % k
        y = swiglu(flat[tok], p["e_gate"][j], p["e_up"][j], p["e_down"][j],
                   matmul)
        out = out.index_add(0, tok, y * weight[tok, slot][:, None])
    first = F.one_hot(choice[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.sum(first * probs.mean(0))
    return out.reshape(b, s, d), aux


def layer(cfg, p, h, matmul):
    eps = cfg["rms_norm_eps"]
    h = h + attention(cfg, p, rmsnorm(h, p["attn_norm"], eps), matmul)
    if cfg.get("num_local_experts"):
        y, aux = moe(cfg, p, rmsnorm(h, p["moe_norm"], eps), matmul)
        return h + y, aux
    y = swiglu(rmsnorm(h, p["mlp_norm"], eps), p["w_gate"], p["w_up"],
               p["w_down"], matmul)
    return h + y, torch.zeros((), device=h.device)


def loss(cfg, params, tokens, matmul=_f32_matmul):
    """Mean next-token cross-entropy of tokens (B, S + 1), plus the
    router's load-balance term for a mixture of experts."""
    inputs, targets = tokens[:, :-1].long(), tokens[:, 1:].long()
    h = params["embed"][inputs]
    aux = torch.zeros((), device=h.device)
    blocks = params["blocks"]
    for i in range(cfg["num_hidden_layers"]):
        h, a = layer(cfg, {n: w[i] for n, w in blocks.items()}, h, matmul)
        aux = aux + a
    h = rmsnorm(h, params["final_norm"], cfg["rms_norm_eps"])
    logits = matmul(h, params["head"])
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1))
    return ce + cfg.get("router_aux_loss_coef", 0.0) * aux
