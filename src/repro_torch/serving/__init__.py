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
    DeadlineExceeded,
    HostReadError,
    HostTransport,
    MemoryExhausted,
    PoisonedAdapter,
    RequestError,
    RequestStatus,
    UnknownAdapter,
    page_arrays_finite,
    validate_lora_tree,
)
from .memory import AdapterMemoryManager

__all__ = [
    "AdapterMemoryManager", "AdapterStore", "AdapterValidationError",
    "DeadlineExceeded", "HostReadError", "HostTransport", "MemoryExhausted",
    "MultiLoRAEngine", "PoisonedAdapter", "QuantizedAdapter", "Request",
    "RequestError", "RequestStatus", "TensorSpec", "UnknownAdapter",
    "dequantize_adapter", "iter_lora_linears", "page_arrays_finite",
    "quantize_adapter_tree", "validate_lora_tree",
]
