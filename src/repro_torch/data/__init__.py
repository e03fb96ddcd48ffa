"""Deterministic synthetic data (numpy batches; PyTorch port)."""

from .pipeline import (DataConfig, make_batch, make_batch_specs,
                       synthetic_batches)

__all__ = ["DataConfig", "make_batch", "make_batch_specs",
           "synthetic_batches"]
