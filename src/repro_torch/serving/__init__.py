from .engine import (
    AdapterStore,
    MultiLoRAEngine,
    QuantizedAdapter,
    Request,
    TensorSpec,
    dequantize_adapter,
    iter_lora_linears,
    quantize_adapter_tree,
)
from .faults import (
    AdapterValidationError,
    RequestError,
    RequestStatus,
    UnknownAdapter,
    validate_lora_tree,
)

__all__ = [
    "AdapterStore", "AdapterValidationError", "MultiLoRAEngine",
    "QuantizedAdapter", "Request", "RequestError", "RequestStatus",
    "TensorSpec", "UnknownAdapter", "dequantize_adapter", "iter_lora_linears",
    "quantize_adapter_tree", "validate_lora_tree",
]
