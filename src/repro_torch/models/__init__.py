"""The model zoo (only the dense attn_mlp family is ported so far)."""
