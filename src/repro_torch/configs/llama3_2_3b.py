"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B card family].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
"""
from repro_torch.models.model import ModelConfig

SOURCE = "hf:meta-llama/Llama-3.2-3B"


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", num_layers=28, d_model=3072, num_heads=24,
        num_kv_heads=8, d_ff=8192, vocab_size=128256,
        block="attn_mlp", rope_theta=500000.0, source=SOURCE)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512,
        block="attn_mlp", rope_theta=10000.0, remat=False, source=SOURCE)
