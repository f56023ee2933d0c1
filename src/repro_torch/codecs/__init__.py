"""Codec stages (only the NDSC leaf is ported so far)."""
