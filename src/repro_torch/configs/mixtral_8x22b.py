"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2,
SWA window 4096 — the window is what lets long_500k decode run with a
bounded ring cache.
"""
from repro_torch.models.model import ModelConfig

SOURCE = "arXiv:2401.04088 (Mixtral)"


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", num_layers=56, d_model=6144, num_heads=48,
        num_kv_heads=8, d_ff=16384, vocab_size=32768,
        block="attn_moe", num_experts=8, top_k=2,
        attention_kind="sliding", window=4096,
        rope_theta=1_000_000.0, source=SOURCE)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=512,
        block="attn_moe", num_experts=4, top_k=2,
        attention_kind="sliding", window=64,
        rope_theta=10000.0, remat=False, source=SOURCE)
