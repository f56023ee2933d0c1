"""mellum2-12b-a2.5b [moe] — sliding and full attention layers in one
stack, YaRN on the full ones, 64 experts top-8 [JetBrains, Mellum2-12B-
A2.5B-Instruct, config.json].

28L d_model=2304 32H (GQA kv=4, head_dim 128, so q_dim 4096 ≠ d_model),
MoE 64 experts of width 896, top-8, renormalized, no shared expert,
vocab=98304, untied, RMSNorm eps 1e-6. Layers repeat (sliding, sliding,
sliding, full) with a window of 1024. RoPE θ 500000 on every layer; the
full layers' table is YaRN (factor 16 from 8192 positions, β_fast 32,
β_slow 1, attention factor 1.2773). Not in the reference's registry:
the port only. The catalog's "MTP head" has no key in the config and is
left out; the router's aux coefficient is assumed (0.001).
"""
from repro_torch.models.model import ModelConfig, RopeSpec

SOURCE = ("https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct "
          "(config.json)")
PERIOD = ("sliding", "sliding", "sliding", "full")


def config() -> ModelConfig:
    return ModelConfig(
        name="mellum2-12b-a2.5b", num_layers=28, d_model=2304, num_heads=32,
        num_kv_heads=4, head_dim=128, d_ff=896, vocab_size=98304,
        block="attn_moe", num_experts=64, top_k=8, moe_aux_coeff=0.001,
        window=1024, layer_types=PERIOD * 7, rope_theta=500000.0,
        rope_by_type=(("full", RopeSpec(
            500000.0, factor=16.0, original_max_position=8192,
            beta_fast=32.0, beta_slow=1.0,
            attention_factor=1.2772588722239782)),),
        norm_eps=1e-6, source=SOURCE)


def reduced() -> ModelConfig:
    """One period at toy widths: a window shorter than the blocks the
    tests use, YaRN from 64 positions, 8 experts top-4."""
    return ModelConfig(
        name="mellum2-smoke", num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=64, vocab_size=512,
        block="attn_moe", num_experts=8, top_k=4, moe_aux_coeff=0.001,
        window=48, layer_types=PERIOD, rope_theta=10000.0,
        rope_by_type=(("full", RopeSpec(
            10000.0, factor=4.0, original_max_position=64)),),
        norm_eps=1e-6, remat=False, source=SOURCE)
