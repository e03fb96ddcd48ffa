"""Deterministic synthetic data pipeline (port of ``repro/data/pipeline.py``).

Training data is synthesized: a second-order Markov stream drawn from a
fixed random transition table, so eval loss falls under training and
quantization quality differences are measurable. The stream is a pure
function of ``(seed, step, shard)`` (restartable, host-sharded), and every
draw comes from numpy in the reference's order, so batches are bit-exact
against the JAX package's.

Batches are numpy arrays; a caller moves them to its device explicitly
(``torch.from_numpy(v).to(device)``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

__all__ = ["DataConfig", "make_batch", "make_batch_specs",
           "synthetic_batches"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    n_codebooks: int = 0          # musicgen
    vision_tokens: int = 0        # qwen2-vl stub prefix length
    d_model: int = 0              # for vision embeds
    shard_index: int = 0          # data-parallel host shard
    shard_count: int = 1


def _markov_table(vocab: int, seed: int, branch: int = 8) -> np.ndarray:
    """(vocab, branch) successor table — each context has ``branch`` likely
    next tokens; the task is to learn the table."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    return rng.integers(0, vocab, size=(vocab, branch), dtype=np.int32)


def _gen_tokens(cfg: DataConfig, step: int, batch: int, seq: int) -> np.ndarray:
    table = _markov_table(cfg.vocab, cfg.seed)
    rng = np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 131 + cfg.shard_index)
    branch = table.shape[1]
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, cfg.vocab, size=batch)
    picks = rng.integers(0, branch, size=(batch, seq))
    # 10% uniform noise keeps entropy non-zero
    noise = rng.random((batch, seq)) < 0.1
    randy = rng.integers(0, cfg.vocab, size=(batch, seq))
    for t in range(seq):
        nxt = table[toks[:, t], picks[:, t]]
        toks[:, t + 1] = np.where(noise[:, t], randy[:, t], nxt)
    return toks


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """One *host-shard* batch for ``step`` (pure function — restartable):
    ``tokens`` / ``targets`` ``(B, T)`` int32 (``(B, K, T)`` with
    codebooks) and, for a vision stub, ``vision_embeds (B, Tv, d)`` fp32."""
    local = cfg.global_batch // cfg.shard_count
    if cfg.n_codebooks:
        streams = [
            _gen_tokens(dataclasses.replace(cfg, seed=cfg.seed + 7 * k), step,
                        local, cfg.seq_len)
            for k in range(cfg.n_codebooks)
        ]
        toks = np.stack([s[:, :-1] for s in streams], axis=1)   # (B, K, T)
        tgts = np.stack([s[:, 1:] for s in streams], axis=1)
        batch = {"tokens": toks, "targets": tgts}
    else:
        stream = _gen_tokens(cfg, step, local, cfg.seq_len)
        batch = {"tokens": stream[:, :-1], "targets": stream[:, 1:]}
    if cfg.vision_tokens:
        rng = np.random.default_rng(cfg.seed * 31 + step)
        batch["vision_embeds"] = rng.normal(
            size=(local, cfg.vision_tokens, cfg.d_model)).astype(np.float32) * 0.02
    return batch


def synthetic_batches(cfg: DataConfig,
                      start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, step)
        step += 1


def make_batch_specs(cfg: DataConfig) -> Dict[str, torch.Tensor]:
    """Stand-ins of a *global* batch for the sharding rules: the keys,
    shapes and dtypes of :func:`make_batch`'s batch as ``meta`` tensors (no
    storage)."""
    b, t = cfg.global_batch, cfg.seq_len
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                            device="meta")
    if cfg.n_codebooks:
        specs = {"tokens": meta((b, cfg.n_codebooks, t), torch.int32),
                 "targets": meta((b, cfg.n_codebooks, t), torch.int32)}
    else:
        specs = {"tokens": meta((b, t), torch.int32),
                 "targets": meta((b, t), torch.int32)}
    if cfg.vision_tokens:
        specs["vision_embeds"] = meta((b, cfg.vision_tokens, cfg.d_model),
                                      torch.float32)
    return specs
