"""Optimizer (PyTorch port of ``repro/optim``): AdamW with the paper's
cosine-with-warmup schedule, and error-feedback int8 gradient compression
for the data-parallel all-reduce (``compress.py``)."""

from .adamw import (
    OptimizerConfig,
    OptState,
    adamw_update,
    clip_by_global_norm,
    cosine_with_warmup,
    global_norm,
    init_opt_state,
)
from .compress import (
    compress_with_feedback,
    compressed_psum_mean,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)

__all__ = [
    "OptimizerConfig", "OptState", "adamw_update", "clip_by_global_norm",
    "cosine_with_warmup", "global_norm", "init_opt_state",
    "compress_with_feedback", "compressed_psum_mean", "dequantize_int8",
    "init_error_feedback", "quantize_int8",
]
