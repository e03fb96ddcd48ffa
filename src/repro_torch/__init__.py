"""PyTorch/CUDA port of the LoRAQuant serving system.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and public names (``repro.core.quant`` → ``repro_torch.core.quant``,
and so on) and never imports it or JAX. The one TPU kernel on the serving
path, ``sgmv_fused``, is a hand-written CUDA kernel for Hopper
(``kernels/quant_matmul/csrc/sgmv_fused.cu``).

Entry points run on the card unless the caller passes ``device="cpu"``: on a
CPU tensor every kernel wrapper takes its plain PyTorch version, which is
what the CPU tests hold against JAX.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for but
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch path")
    return dev
