"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219].

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.models.model import ModelConfig

SOURCE = "arXiv:2404.14219 (Phi-3)"


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", num_layers=32, d_model=3072, num_heads=32,
        num_kv_heads=32, d_ff=8192, vocab_size=32064,
        block="attn_mlp", rope_theta=10000.0, source=SOURCE)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=512,
        block="attn_mlp", rope_theta=10000.0, remat=False, source=SOURCE)
