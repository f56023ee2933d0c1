"""Model FLOPs of a training step, from a configuration file's sizes.

The count follows `model_flops_train` of `src/repro_torch/launch/
hlo_analysis.py` at commit 79e5167 (6·N·D), with two departures: N counts
only the parameters that enter a matrix product for each token (the
embedding table is a lookup and is left out; the LM head is kept; of a
mixture of experts, the experts a token is routed to), and attention's
score and value products add 12·L·s·d a token (PaLM's accounting, not
halved for the causal mask). Recomputation under remat is not counted.
"""
from __future__ import annotations


def matmul_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies by in the forward pass."""
    d = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    dh = cfg.get("head_dim") or d // heads
    kv = cfg["num_key_value_heads"] * dh
    attn = d * heads * dh + 2 * d * kv + heads * dh * d
    ff = cfg["intermediate_size"]
    experts = cfg.get("num_local_experts", 0)
    if experts:
        mlp = 3 * d * ff * cfg["num_experts_per_tok"] + d * experts
    else:
        mlp = 3 * d * ff
    return cfg["num_hidden_layers"] * (attn + mlp) + d * cfg["vocab_size"]


def train_flops_per_token(cfg: dict, seq: int) -> float:
    """6·N + 12·L·s·d: forward and backward of the products and of
    attention's two products over `seq` positions."""
    return (6.0 * matmul_params_per_token(cfg)
            + 12.0 * cfg["num_hidden_layers"] * seq * cfg["hidden_size"])
