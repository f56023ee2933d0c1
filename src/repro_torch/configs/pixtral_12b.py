"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
The vision frontend is a stub: input_specs() provides
precomputed patch embeddings (B, 1024, d_model); this module is the language
decoder that consumes them (image prefix + text suffix, loss on text only).
"""
from repro_torch.models.model import ModelConfig

SOURCE = "hf:mistralai/Pixtral-12B-2409"


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", num_layers=40, d_model=5120, num_heads=32,
        num_kv_heads=8, d_ff=14336, vocab_size=131072, head_dim=128,
        block="attn_mlp", frontend="vision", num_patches=1024,
        rope_theta=1_000_000.0, source=SOURCE)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
        block="attn_mlp", frontend="vision", num_patches=16,
        rope_theta=10000.0, remat=False, source=SOURCE)
