"""xlstm-350m [ssm] — alternating sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304. The scanned unit is an
(mLSTM, sLSTM) pair — 12 pairs for 24 layers; d_ff=0 (no FFN in the xLSTM
block recipe). Fully recurrent (O(1) state/token) → long_500k runs natively.
"""
from repro_torch.models.model import ModelConfig

SOURCE = "arXiv:2405.04517 (xLSTM)"


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", num_layers=24, d_model=1024, num_heads=4,
        num_kv_heads=4, d_ff=0, vocab_size=50304,
        block="xlstm_pair", source=SOURCE)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=0, vocab_size=512,
        block="xlstm_pair", remat=False, source=SOURCE)
