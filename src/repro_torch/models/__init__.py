"""Decoder LMs with LoRA on every linear (PyTorch port): dense GQA and
sparse MoE with sliding-window attention."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
