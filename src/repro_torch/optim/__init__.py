"""Optimizer (PyTorch port of ``repro/optim``): AdamW with the paper's
cosine-with-warmup schedule. The error-feedback int8 gradient compression
(``compress.py``) is not ported yet (ROADMAP A8b)."""

from .adamw import (
    OptimizerConfig,
    OptState,
    adamw_update,
    clip_by_global_norm,
    cosine_with_warmup,
    global_norm,
    init_opt_state,
)

__all__ = [
    "OptimizerConfig", "OptState", "adamw_update", "clip_by_global_norm",
    "cosine_with_warmup", "global_norm", "init_opt_state",
]
