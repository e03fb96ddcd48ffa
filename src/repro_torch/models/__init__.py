"""Decoder LMs with LoRA on every linear (PyTorch port): dense GQA,
sparse MoE with sliding-window attention, MLA, and the recurrent RWKV-6
and RG-LRU mixers."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
