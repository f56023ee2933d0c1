"""Compressed gradient consensus: the NDSC codec and the train step."""
