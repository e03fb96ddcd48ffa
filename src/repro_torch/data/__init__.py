"""Deterministic synthetic data (numpy only; PyTorch port)."""

from .pipeline import DataConfig, make_batch, synthetic_batches

__all__ = ["DataConfig", "make_batch", "synthetic_batches"]
