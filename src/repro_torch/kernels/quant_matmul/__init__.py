from .kernel import (
    LAUNCH_COUNTS,
    PLAIN_CALLS,
    fused_lora,
    matmul_out,
    matmul_rhs,
    reset_launch_counts,
    sgmv_fused,
)
from .ops import (
    PackedLoRABatch,
    lora_apply_quantized,
    pack_adapter_layers,
    quant_matmul_rhs,
    retile_packed,
    sgmv_apply_packed,
    stack_packed_adapters,
)
from .ref import fused_lora_ref, matmul_out_ref, matmul_rhs_ref, sgmv_fused_ref
from . import ref

__all__ = [
    "LAUNCH_COUNTS",
    "PLAIN_CALLS",
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
    "ref",
    "reset_launch_counts",
    "retile_packed",
    "sgmv_apply_packed",
    "sgmv_fused",
    "sgmv_fused_ref",
    "stack_packed_adapters",
]
