"""hubert-xlarge [audio] — encoder-only, same arch as wav2vec2 [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (cluster targets).
The conv/mel frontend is a stub: input_specs() provides
precomputed frame embeddings (B, S, d_model); this module is the bidirectional
transformer encoder with the masked-cluster prediction head. Encoder-only →
no decode shapes (`configs.shapes.applicable`).
"""
from repro_torch.models.model import ModelConfig

SOURCE = "arXiv:2106.07447 (HuBERT)"


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", num_layers=48, d_model=1280, num_heads=16,
        num_kv_heads=16, d_ff=5120, vocab_size=504,
        block="encoder", causal=False, frontend="audio",
        rope_theta=10000.0, source=SOURCE)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=64,
        block="encoder", causal=False, frontend="audio",
        rope_theta=10000.0, remat=False, source=SOURCE)
