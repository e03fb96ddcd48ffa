"""Train / eval / serve steps (port of ``repro/launch/step.py``).

``make_train_step`` builds the training step:

* LoRA-only gradients (frozen base — the paper's QLoRA-style setup);
* microbatch gradient accumulation in fp32 (activation memory is one
  microbatch), then one AdamW update with the paper's Appendix-A schedule;
* per-layer recomputation on the backward pass when the model has
  ``remat`` set.

The reference's error-feedback int8 gradient compression across a pod
axis belongs to the training entry point ``launch/train.py`` (ROADMAP
A8b).
"""

from __future__ import annotations

import torch

from repro_torch.optim import OptimizerConfig, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map

__all__ = ["make_train_step", "make_eval_step", "make_serve_step",
           "make_prefill_step"]


def _split_microbatches(batch, n_micro: int):
    """Every batch leaf ``(B, ...)`` → ``(n_micro, B / n_micro, ...)``;
    M-RoPE positions ``(3, B, T)`` → ``(n_micro, 3, B / n_micro, T)``."""
    def resh(x):
        b = x.shape[0]
        if x.dim() == 3 and x.shape[0] == 3:       # (3, B, T) mrope positions
            return x.reshape((3, n_micro, -1) + tuple(x.shape[2:])
                             ).transpose(0, 1)
        return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))

    return tree_map(resh, batch)


def _lora_grads(model, params, batch, n_microbatches: int = 1):
    """``(loss, metrics, grads)``: the loss and the gradients of the LoRA
    leaves (fp32, accumulated over ``n_microbatches`` and averaged; the
    base is frozen), metrics from the last microbatch."""
    base, lora = params["base"], params["lora"]
    leaves = tree_leaves(lora)

    def grad_fn(mb):
        lora_p = tree_map(lambda p: p.detach().requires_grad_(True), lora)
        leaves_p = tree_leaves(lora_p)
        with torch.enable_grad():
            loss, metrics = model.train_loss({"base": base, "lora": lora_p},
                                             mb)
            gs = torch.autograd.grad(loss, leaves_p, allow_unused=True)
        by_leaf = {id(p): torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves_p, gs)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda p: by_leaf[id(p)], lora_p))

    if n_microbatches == 1:
        return grad_fn(batch)
    micro = _split_microbatches(batch, n_microbatches)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), lora)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=leaves[0].device)
    for i in range(n_microbatches):
        loss, metrics, g = grad_fn(tree_map(lambda x: x[i], micro))
        acc = tree_map(lambda a, x: a + x.to(torch.float32), acc, g)
        loss_sum = loss_sum + loss
    grads = tree_map(lambda g: g / n_microbatches, acc)
    return loss_sum / n_microbatches, metrics, grads


def make_train_step(model, opt_cfg: OptimizerConfig, n_microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``metrics`` holds ``loss``, ``ce``, ``aux``, ``lr`` and
    ``grad_norm``. ``batch`` is a dict of tensors on the params' device."""
    def train_step(params, opt_state, batch):
        loss, metrics, grads = _lora_grads(model, params, batch,
                                           n_microbatches)
        with torch.no_grad():
            new_lora, new_opt, om = adamw_update(grads, opt_state,
                                                 params["lora"], opt_cfg)
        out_params = {"base": params["base"], "lora": new_lora}
        return out_params, new_opt, {"loss": loss, **metrics, **om}

    return train_step


def make_eval_step(model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.train_loss(params, batch)
        return {"loss": loss, **metrics}

    return eval_step


def make_serve_step(model):
    """One decode step: (params, tokens, caches, pos) -> (logits, caches)."""

    def serve_step(params, tokens, caches, pos):
        return model.decode_step(params, tokens, caches, pos)

    return serve_step


def make_prefill_step(model, capacity: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, capacity)

    return prefill_step
