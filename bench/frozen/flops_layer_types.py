"""Model FLOPs of a training step of a model whose layers differ in their
attention (`layer_types`: sliding and full), from a configuration's
sizes (the weights view of `bench.train_layer_types.weights_cfg`).

The accounting of `bench.frozen.flops`: 6·N a token, N the weights in a
token's products (`flops.matmul_params_per_token`: the attention's
projections, the router and the k experts a token is routed to, the LM
head; not the embedding), plus attention's score and value products,
12·q_dim·c a token a layer, c the keys a query may see at most: the
sequence on a full layer, min(seq, window) on a sliding one (not halved
for the causal mask, as `flops` does not halve it). Recomputation under
remat is not counted.
"""
from __future__ import annotations

from bench.frozen import flops


def context(cfg: dict, seq: int) -> int:
    """Σ over the layers of the keys a query may see at most."""
    kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
    return sum(min(seq, cfg["sliding_window"]) if k.startswith("sliding")
               else seq for k in kinds)


def train_flops_per_token(cfg: dict, seq: int) -> float:
    q_dim = cfg["num_attention_heads"] * cfg["head_dim"]
    return (6.0 * flops.matmul_params_per_token(cfg)
            + 12.0 * q_dim * context(cfg, seq))
