"""hymba-1.5b [hybrid] — parallel attention + Mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hymba runs sliding-window attention in all but three layers; we model the
SWA configuration uniformly (window 1024 per the paper's global-local split),
which is what makes long_500k decode feasible for this arch.
"""
from repro_torch.models.model import ModelConfig

SOURCE = "arXiv:2411.13676 (Hymba)"


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", num_layers=32, d_model=1600, num_heads=25,
        num_kv_heads=5, d_ff=5504, vocab_size=32001, head_dim=64,
        block="hybrid", attention_kind="sliding", window=1024,
        ssm_state=16, d_inner=1600, rope_theta=10000.0, source=SOURCE)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
        block="hybrid", attention_kind="sliding", window=64,
        ssm_state=8, d_inner=128, rope_theta=10000.0, remat=False,
        source=SOURCE)
