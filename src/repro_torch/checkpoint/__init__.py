"""Fault-tolerant checkpointing (PyTorch port of ``repro/checkpoint``)."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
