"""The inputs of a cell, made from its seed: the weights, in the layout the
program takes (`blocks` stacked over the layers, then `embed`,
`final_norm`, `head`), and the token rows. Both sides are handed the same.

Each leaf is drawn by a generator of its own on the device, seeded from
(seed, leaf index), in one call: norms are ones, every matrix N(0,
0.02²) (the configurations' `initializer_range`). So one leaf can be made
again alone, and the reference remakes the initial weights after the
window instead of a copy being kept beside the program's state.
"""
from __future__ import annotations

import math

import torch

VOCAB_PAD = 256          # the program pads the vocabulary to this multiple


def _mix(seed: int, salt: int) -> int:
    """A generator seed from a run's seed (any size) and a salt."""
    return (seed * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9
            + 1) % (1 << 63)


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // VOCAB_PAD) * VOCAB_PAD


def leaf_shapes(cfg: dict) -> list:
    """[(path, shape)] in the order the program flattens its tree (dicts
    by sorted key): path ("blocks", name) or (name,)."""
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    dh = cfg.get("head_dim") or d // heads
    q, kv, ff = heads * dh, cfg["num_key_value_heads"] * dh, \
        cfg["intermediate_size"]
    block = {"attn_norm": (d,), "wq": (d, q), "wk": (d, kv), "wv": (d, kv),
             "wo": (q, d)}
    e = cfg.get("num_local_experts", 0)
    if e:
        block.update(moe_norm=(d,), router=(d, e), e_gate=(e, d, ff),
                     e_up=(e, d, ff), e_down=(e, ff, d))
    else:
        block.update(mlp_norm=(d,), w_gate=(d, ff), w_up=(d, ff),
                     w_down=(ff, d))
    v = padded_vocab(cfg)
    top = {"embed": (v, d), "final_norm": (d,), "head": (d, v)}
    out = [(("blocks", k), (n,) + block[k]) for k in sorted(block)]
    return out + [((k,), top[k]) for k in sorted(top)]


def make_leaf(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    path, shape = leaf_shapes(cfg)[index]
    if path[-1].endswith("norm"):
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix(seed, index))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.normal_(0.0, cfg.get("initializer_range", 0.02), generator=gen)


def make_params(cfg: dict, seed: int, device) -> dict:
    tree: dict = {"blocks": {}}
    for i, (path, _) in enumerate(leaf_shapes(cfg)):
        leaf = make_leaf(cfg, seed, i, device)
        if path[0] == "blocks":
            tree["blocks"][path[1]] = leaf
        else:
            tree[path[0]] = leaf
    return tree


def leaves(tree: dict) -> list:
    """The tree's leaves in `leaf_shapes` order."""
    return [tree["blocks"][p[1]] if p[0] == "blocks" else tree[p[0]]
            for p in _paths(tree)]


def _paths(tree: dict) -> list:
    return ([("blocks", k) for k in sorted(tree["blocks"])]
            + [(k,) for k in sorted(k for k in tree if k != "blocks")])


def leaf_names(cfg: dict) -> list:
    return [".".join(p) for p, _ in leaf_shapes(cfg)]


def param_count(cfg: dict) -> int:
    return sum(math.prod(s) for _, s in leaf_shapes(cfg))


def token_rows(cfg: dict, seed: int, count: int, batch: int, seq: int,
               device) -> torch.Tensor:
    """`count` batches of `batch` rows of seq + 1 token ids, uniform over
    the vocabulary: (count, batch, seq + 1) int32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix(seed, 0x7F4A7C15))
    return torch.randint(0, cfg["vocab_size"], (count, batch, seq + 1),
                         generator=gen, device=device, dtype=torch.int64
                         ).to(torch.int32)
