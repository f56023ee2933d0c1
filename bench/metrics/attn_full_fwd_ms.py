"""attn_full_fwd_ms: device milliseconds a training step's forward spends
in the attention sublayers of the full (causal, YaRN) layers, from each
`repro_mark_attn_full` to the next mark (`bench.sublayers`), over the
steps traced."""
from bench import sublayers

LAYER = "attention (models/layers.py blockwise_attention, rope_table)"
MOVES = "train_tokens_per_s"


def read(trace):
    return sublayers.forward_ms(trace, ("attn_full",))
