"""Synthetic data pipeline."""
