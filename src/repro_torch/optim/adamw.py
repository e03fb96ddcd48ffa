"""AdamW + cosine-with-warmup schedule (port of ``repro/optim/adamw.py``),
matching the paper's Appendix A training recipe (β = [0.9, 0.95], lr 2e-4,
α_f = 0.01, warmup 0.3·duration, grad-clip 1.0).

Plain functions on trees of tensors (nested dicts / lists / tuples), all
arithmetic in fp32 as the reference does it: the schedule, ``b**step`` and
the bias corrections are float32 tensors. :func:`tree_leaves` walks a tree
in ``jax.tree_util.tree_leaves`` order (dict keys sorted), so
:func:`global_norm` sums the leaves in the reference's order, and
:func:`tree_paths` names each leaf as ``jax.tree_util.keystr`` does (the
sharding rules and the checkpoint files key on those names).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

__all__ = ["OptimizerConfig", "OptState", "adamw_update",
           "clip_by_global_norm", "cosine_with_warmup", "global_norm",
           "init_opt_state", "tree_leaves", "tree_map", "tree_map_with_path",
           "tree_paths"]


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts / lists / tuples in JAX's order (dict
    keys sorted); ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in :func:`tree_leaves` order, each path
    spelled as ``jax.tree_util.keystr`` spells it: ``['key']`` for a dict
    entry, ``[i]`` for a list or tuple item and ``.name`` for a named
    tuple's field (``.mu['groups'][0]['sub_0']['mixer']['wq']['a']``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for f in tree._fields
                for pl in tree_paths(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree`` (paths as in
    :func:`tree_paths`); the result has ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f),
                                               f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    warmup_frac: float = 0.3
    alpha_f: float = 0.01          # final lr fraction (cosine floor)
    total_steps: int = 1000


class OptState(NamedTuple):
    step: torch.Tensor             # int32 scalar
    mu: Any
    nu: Any


def cosine_with_warmup(step, cfg: OptimizerConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a scalar tensor), fp32."""
    warm = max(int(cfg.warmup_frac * cfg.total_steps), 1)
    t = torch.as_tensor(step).to(torch.float32)
    warm_lr = cfg.lr * t / warm
    prog = torch.clamp((t - warm) / max(cfg.total_steps - warm, 1), 0.0, 1.0)
    cos_lr = cfg.lr * (cfg.alpha_f + (1 - cfg.alpha_f) * 0.5
                       * (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warm, warm_lr, cos_lr)


def init_opt_state(params) -> OptState:
    """Zero fp32 moments shaped like ``params``, on their device."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros, nu=tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    """fp32 L2 norm over every leaf, summed in JAX's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """``grads`` scaled to at most ``max_norm``; ``norm`` is their global
    norm when the caller has it (gradients held in blocks across ranks)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(grads, opt_state: OptState, params, cfg: OptimizerConfig,
                 norm=None) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step on ``params`` (gradients clipped by global norm
    first; ``norm`` as in :func:`clip_by_global_norm`). Returns
    ``(new_params, new_state, {"lr", "grad_norm"})``; the new params keep
    each leaf's dtype."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm)
    b1, b2 = cfg.betas
    step = opt_state.step + 1
    lr = cosine_with_warmup(step, cfg)

    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                  opt_state.mu, grads)
    nu = tree_map(
        lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
        opt_state.nu, grads)
    sf = step.to(torch.float32)
    mu_hat_scale = 1.0 / (1 - torch.pow(b1, sf))
    nu_hat_scale = 1.0 / (1 - torch.pow(b2, sf))

    def upd(p, m, v):
        u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + cfg.eps)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, OptState(step=step, mu=mu, nu=nu), {
        "lr": lr, "grad_norm": gnorm}
