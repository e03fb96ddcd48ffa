"""Hand-written Hopper kernels of the serving path and their plain PyTorch
versions (``quant_matmul``)."""

from .quant_matmul import (
    PackedLoRABatch,
    pack_adapter_layers,
    retile_packed,
    sgmv_apply_packed,
    stack_packed_adapters,
)

__all__ = [
    "PackedLoRABatch",
    "pack_adapter_layers",
    "retile_packed",
    "sgmv_apply_packed",
    "stack_packed_adapters",
]
