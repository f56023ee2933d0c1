"""attn_fwd_roofline: the least time of the forward's attention sublayers
over their device time (`attn_sliding_fwd_ms` + `attn_full_fwd_ms`), in
%. The least time is the work the layers need at 67 TFLOP/s f32
(`bench.frozen.cost`), whatever the implementation computes: each
layer's q/k/v/o products, 2·s·(d·q_dim + 2·d·kv_dim + q_dim·d) FLOPs a
row, and 4·q_dim FLOPs (the score and the value product) for each
(query, key) pair the layer allows: key j ≤ query i, and j > i − window
on a sliding layer."""
from bench import sublayers
from bench.frozen import cost

LAYER = "attention (models/layers.py blockwise_attention, rope_table)"
MOVES = "train_tokens_per_s"


def allowed_pairs(seq: int, window) -> int:
    """(query, key) pairs with j ≤ i (and j > i − window) over seq
    positions."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def needed_flops(cfg: dict, batch: int, seq: int) -> float:
    d, dh = cfg["hidden_size"], cfg["head_dim"]
    q_dim = cfg["num_attention_heads"] * dh
    kv_dim = cfg["num_key_value_heads"] * dh
    total = 0.0
    for kind in cfg["layer_types"][:cfg["num_hidden_layers"]]:
        window = cfg["sliding_window"] if kind.startswith("sliding") \
            else None
        total += 2.0 * seq * (2 * d * q_dim + 2 * d * kv_dim)
        total += 4.0 * q_dim * allowed_pairs(seq, window)
    return batch * total


def read(trace):
    cfg, mix = trace.cell["cfg"], trace.cell["mix"]
    if "layer_types" not in cfg:
        return None
    ms = sublayers.forward_ms(trace, ("attn_sliding", "attn_full"))
    if ms is None:
        return None
    least_s = needed_flops(cfg, mix["batch"], mix["seq"]) / \
        cost.PEAK_F32_FLOP_S
    return 100.0 * least_s / (ms * 1e-3)
