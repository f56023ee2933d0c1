"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
Arctic is a dense-MoE hybrid: every layer has a dense residual MLP in
parallel with the 128-expert top-2 MoE FFN (block="attn_moe_dense").
"""
from repro_torch.models.model import ModelConfig

SOURCE = "hf:Snowflake/snowflake-arctic-base"


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", num_layers=35, d_model=7168, num_heads=56,
        num_kv_heads=8, d_ff=4864, vocab_size=32000,
        block="attn_moe_dense", num_experts=128, top_k=2,
        rope_theta=10000.0, source=SOURCE)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="arctic-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=512,
        block="attn_moe_dense", num_experts=4, top_k=2,
        rope_theta=10000.0, remat=False, source=SOURCE)
