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
    FaultPlan,
    HostReadError,
    HostTransport,
    MemoryExhausted,
    PoisonedAdapter,
    QueueFull,
    RequestError,
    RequestStatus,
    UnknownAdapter,
    named_plan,
    page_arrays_finite,
    validate_lora_tree,
)
from .memory import AdapterMemoryManager
from .telemetry import ManualClock, MetricsRegistry, Telemetry

__all__ = [
    "AdapterMemoryManager", "AdapterStore", "AdapterValidationError",
    "DeadlineExceeded", "FaultPlan", "HostReadError", "HostTransport",
    "ManualClock", "MemoryExhausted", "MetricsRegistry", "MultiLoRAEngine",
    "PoisonedAdapter", "QuantizedAdapter", "QueueFull", "Request",
    "RequestError", "RequestStatus", "TensorSpec", "Telemetry",
    "UnknownAdapter", "dequantize_adapter", "iter_lora_linears",
    "named_plan", "page_arrays_finite", "quantize_adapter_tree",
    "validate_lora_tree",
]
