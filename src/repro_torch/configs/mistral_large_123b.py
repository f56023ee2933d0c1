"""mistral-large-123b [dense] — [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from repro_torch.models.model import ModelConfig

SOURCE = "hf:mistralai/Mistral-Large-Instruct-2407"


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", num_layers=88, d_model=12288,
        num_heads=96, num_kv_heads=8, d_ff=28672, vocab_size=32768,
        block="attn_mlp", rope_theta=1_000_000.0, source=SOURCE)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512,
        block="attn_mlp", rope_theta=10000.0, remat=False, source=SOURCE)
