"""yi-6b [dense] — llama-arch GQA [arXiv:2403.04652].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.models.model import ModelConfig

SOURCE = "arXiv:2403.04652 (Yi)"


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", num_layers=32, d_model=4096, num_heads=32,
        num_kv_heads=4, d_ff=11008, vocab_size=64000,
        block="attn_mlp", rope_theta=5_000_000.0, source=SOURCE)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512,
        block="attn_mlp", rope_theta=10000.0, remat=False, source=SOURCE)
