from .kernel import LAUNCH_COUNTS, PLAIN_CALLS, reset_launch_counts, sgmv_fused
from .ops import (
    PackedLoRABatch,
    pack_adapter_layers,
    retile_packed,
    sgmv_apply_packed,
    stack_packed_adapters,
)
from .ref import sgmv_fused_ref
from . import ref

__all__ = [
    "LAUNCH_COUNTS",
    "PLAIN_CALLS",
    "PackedLoRABatch",
    "pack_adapter_layers",
    "ref",
    "reset_launch_counts",
    "retile_packed",
    "sgmv_apply_packed",
    "sgmv_fused",
    "sgmv_fused_ref",
    "stack_packed_adapters",
]
