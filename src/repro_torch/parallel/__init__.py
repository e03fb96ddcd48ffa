"""Partition rules over a named mesh (PyTorch port of ``repro/parallel``)."""

from .sharding import (
    AbstractMesh,
    batch_specs,
    cache_specs,
    data_ranks,
    fsdp_axes,
    local_block,
    placements,
    shard_tree,
    spec_for,
)

__all__ = ["AbstractMesh", "batch_specs", "cache_specs", "data_ranks",
           "fsdp_axes", "local_block", "placements", "shard_tree",
           "spec_for"]
