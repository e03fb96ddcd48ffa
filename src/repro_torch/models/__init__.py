"""Dense GQA decoder with LoRA on every linear (PyTorch port)."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
