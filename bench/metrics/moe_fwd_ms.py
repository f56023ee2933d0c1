"""moe_fwd_ms: device milliseconds a training step's forward spends in the
MoE sublayers (`models/moe.py` `moe_ffn`: the norm, the router, the
capacity dispatch into (E, C, d), the experts' batched products, the
combine), summed over the layers, from each `repro_mark_moe` to the
next mark (`bench.sublayers`), over the steps traced."""
from bench import sublayers

LAYER = "mixture of experts (models/moe.py route, moe_ffn)"
MOVES = "train_tokens_per_s"


def read(trace):
    return sublayers.forward_ms(trace, ("moe",))
