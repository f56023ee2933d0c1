"""Mixture-of-Experts block (port of `repro.models.moe`): top-k routing
with sort-based capacity dispatch.

Tokens are dispatched into a dense (E, C, d) buffer (capacity
C = ⌈cf·k·T/E⌉ as the reference computes it, overflow dropped —
GShard-style), the experts run as one batched product, and the outputs are
combined with the router weights.

The reference's `_hint_expert_sharding` pins the dispatch buffer to the
"model" mesh axis; the port has no "model" axis (every expert lives on the
one device of its process), so there is nothing to pin.

Routing is discrete: a last-bit change in the router softmax could flip an
expert. Top-k keeps `jax.lax.top_k`'s tie order (the lower index first)
through a stable descending sort, never `torch.topk`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def top_k(x: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest entries along the last axis,
    ties to the lower index as `jax.lax.top_k` breaks them."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def route(flat: torch.Tensor, router: torch.Tensor, k: int,
          capacity_factor: float) -> dict:
    """The routing of (T, d) tokens over E experts: router probs (T, E),
    the top-k choices `expert_idx` (T, k) and their renormalized `weights`,
    each assignment's `rank` within its expert (token order, the
    reference's stable argsort), `keep` (rank < capacity) and `capacity`."""
    t = flat.shape[0]
    e = router.shape[-1]
    logits = (flat @ router).to(torch.float32)                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, expert_idx = top_k(probs, k)                     # (T, k)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    n = t * k
    flat_e = expert_idx.reshape(n)                            # assignments
    capacity = max(1, int(capacity_factor * t * k / e))
    # rank of each assignment within its expert (stable sort by expert id)
    order = torch.sort(flat_e, stable=True).indices
    # bincount's CUDA kernel reads the largest id back to the host, which a
    # captured graph cannot; a scatter-add counts the same integers
    counts = torch.zeros(e, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    ar = torch.arange(n, device=flat.device)
    rank_sorted = ar - starts[flat_e[order]]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted              # a permutation: one write each
    return {"probs": probs, "weights": weights, "expert_idx": expert_idx,
            "rank": rank, "keep": rank < capacity, "capacity": capacity}


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, return_aux: bool = False):
    """x: (B, S, d); router: (d, E); w_gate/up: (E, d, f); w_down: (E, f, d).
    With `return_aux`, also {"load_balance_loss", "drop_fraction"}."""
    b, s, d = x.shape
    e = router.shape[-1]
    t = b * s
    flat = x.reshape(t, d)
    r = route(flat, router, top_k, capacity_factor)
    flat_e = r["expert_idx"].reshape(t * top_k)
    flat_w = r["weights"].reshape(t * top_k).to(x.dtype)
    keep = r["keep"].to(x.dtype)
    rank_c = torch.clamp_max(r["rank"], r["capacity"] - 1)

    # dispatch: every assignment adds its token into its (expert, rank)
    # slot of the (E, C, d) buffer, a dropped one as exact zeros (at slot
    # C - 1). index_put with accumulate runs as atomic adds on the card, in
    # no fixed order, and stays deterministic all the same: a slot holds at
    # most one kept token, and adding ±0 to a value leaves it unchanged, so
    # every order gives the same bits. The tokens are repeated by a view
    # (expand), whose backward is a sum over the k copies: with top-2 each
    # token's gradient is a + b, which equals b + a.
    src = flat[:, None, :].expand(t, top_k, d).reshape(t * top_k, d)
    src = src * keep[:, None]
    buf = torch.zeros((e, r["capacity"], d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((flat_e, rank_c), src, accumulate=True)

    # expert compute: batched SwiGLU
    gate = F.silu(torch.einsum("ecd,edf->ecf", buf, w_gate))
    up = torch.einsum("ecd,edf->ecf", buf, w_up)
    y = torch.einsum("ecf,efd->ecd", gate * up, w_down)

    # combine: a token's k weighted expert outputs, summed in choice order
    # (the reference's scatter-add of token_of adds them in that order
    # too). The gather's backward accumulates into y's gradient by the same
    # rule as the dispatch: a slot gets one kept gradient and exact zeros
    gathered = y[flat_e, rank_c] * (flat_w * keep)[:, None]
    out = gathered.reshape(t, top_k, d).sum(dim=1).reshape(b, s, d)

    if return_aux:
        # load-balance auxiliary loss (Switch-style): E · Σ_e f_e · p_e
        frac_tokens = torch.mean(
            F.one_hot(r["expert_idx"][:, 0], e).to(torch.float32), dim=0)
        frac_probs = torch.mean(r["probs"], dim=0)
        aux = e * torch.sum(frac_tokens * frac_probs)
        dropped = 1.0 - torch.mean(r["keep"].to(torch.float32))
        return out, {"load_balance_loss": aux, "drop_fraction": dropped}
    return out
