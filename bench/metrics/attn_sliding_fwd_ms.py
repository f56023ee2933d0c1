"""attn_sliding_fwd_ms: device milliseconds a training step's forward
spends in the attention sublayers of the sliding-window layers
(`models/model.py` `_self_attention`: the norm, q/k/v, RoPE, the blockwise
attention with its skipped block pairs, the output product), summed over
those layers, from each `repro_mark_attn_sliding` to the next mark
(`bench.sublayers`), over the steps traced."""
from bench import sublayers

LAYER = "attention (models/layers.py blockwise_attention, rope_table)"
MOVES = "train_tokens_per_s"


def read(trace):
    return sublayers.forward_ms(trace, ("attn_sliding",))
