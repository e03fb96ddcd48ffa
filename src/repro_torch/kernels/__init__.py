"""Hand-written Hopper kernels of the serving path and their plain PyTorch
versions (``quant_matmul``)."""

from .quant_matmul import (
    PackedLoRABatch,
    fused_lora,
    fused_lora_ref,
    lora_apply_quantized,
    matmul_out,
    matmul_out_ref,
    matmul_rhs,
    matmul_rhs_ref,
    pack_adapter_layers,
    quant_matmul_rhs,
    retile_packed,
    sgmv_apply_packed,
    stack_packed_adapters,
)

__all__ = [
    "PackedLoRABatch",
    "fused_lora",
    "fused_lora_ref",
    "lora_apply_quantized",
    "matmul_out",
    "matmul_out_ref",
    "matmul_rhs",
    "matmul_rhs_ref",
    "pack_adapter_layers",
    "quant_matmul_rhs",
    "retile_packed",
    "sgmv_apply_packed",
    "stack_packed_adapters",
]
