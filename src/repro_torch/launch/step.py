"""Train / eval / serve steps (port of ``repro/launch/step.py``).

``make_train_step`` builds the training step:

* LoRA-only gradients (frozen base — the paper's QLoRA-style setup);
* microbatch gradient accumulation in fp32 (activation memory is one
  microbatch), then one AdamW update with the paper's Appendix-A schedule;
* per-layer recomputation on the backward pass when the model has
  ``remat`` set;
* under the model's mesh, data parallelism over its data ranks: each rank
  takes its rows of the global batch (:func:`local_batch`), the loss and
  metrics are averaged across the ranks, the gradients of replicated LoRA
  leaves are all-reduced, and an expert-sharded leaf keeps the gradient
  its experts' all-to-all brought home; and tensor parallelism over its
  ``model`` ranks, which hold one loss and each its block of every
  ``model``-split leaf and of its gradient. The global norm sums each
  leaf's squares over the axes that split it. The reference gets the same
  global loss and gradients from ``pjit`` over the sharded global batch.

Under a mesh the ranks split each microbatch of their own rows, where the
reference splits the global batch first: with several microbatches, MoE
capacity drops see other token groups than the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.optim import OptimizerConfig, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel.collectives import all_reduce_sum
from repro_torch.parallel.sharding import (batch_specs, data_ranks,
                                           local_block)
from repro_torch.parallel.tensor import axes_of

__all__ = ["local_batch", "make_train_step", "make_eval_step",
           "make_serve_step", "make_prefill_step"]


def local_batch(batch, mesh):
    """This rank's rows of a global batch under ``mesh``: rows ``[r·B/S,
    (r+1)·B/S)`` of the batch dim (dim 1 of ``(3, B, T)`` positions).
    Raises when S does not divide the batch."""
    s = data_ranks(mesh)
    if s == 1:
        return batch
    specs = batch_specs(batch, mesh)
    for k, v in batch.items():
        if all(e is None for e in specs[k]):
            raise ValueError(
                f"batch leaf {k!r} of shape {tuple(v.shape)}: its batch dim "
                f"does not divide over the mesh's {s} data ranks")
    return {k: local_block(v, specs[k], mesh, mesh.coords)
            for k, v in batch.items()}


def _mesh_mean(model, loss, metrics, grads):
    """The global loss, metrics and gradients from each rank's: the mean
    across the data ranks of the loss and metrics and of the gradients of
    leaves whole over the data axes; an expert-sharded leaf's gradient
    (summed over the ranks' losses by the all-to-all's backward) over S.
    The ranks of a ``model`` group hold one loss, and each its block of a
    ``model``-split leaf's gradient, so nothing is averaged over them.
    Returns them with the global gradient norm: each leaf's squares summed
    over the axes that split it, each replicated leaf counted once."""
    tp = model.tp
    s = tp.s

    def mean(t):
        t = t.to(torch.float32)
        return t if s == 1 else all_reduce_sum(t, tp.dgroup) / s

    loss, metrics = mean(loss), {k: mean(v) for k, v in metrics.items()}
    specs = model.param_specs(grads)

    def split(sp, model_axis):
        return any(("model" in axes_of(e)) == model_axis and e is not None
                   for e in sp)

    over_data = tree_map(lambda g, sp: split(sp, False), grads, specs)
    over_model = tree_map(lambda g, sp: split(sp, True), grads, specs)
    grads = tree_map(lambda g, sh: g / s if sh else mean(g), grads,
                     over_data)
    # squares by (split over data, split over model)
    sq = torch.zeros((2, 2), dtype=torch.float32, device=loss.device)
    for g, dsh, msh in zip(tree_leaves(grads), tree_leaves(over_data),
                           tree_leaves(over_model)):
        sq[int(dsh), int(msh)] += torch.sum(torch.square(g.to(torch.float32)))
    if s > 1:
        sq = torch.stack([sq[0], all_reduce_sum(sq[1], tp.dgroup)])
    if tp.m > 1:
        sq = torch.stack([sq[:, 0], all_reduce_sum(sq[:, 1], tp.group)],
                         dim=1)
    return loss, metrics, grads, torch.sqrt(sq.sum())


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
    ``grad_norm``. ``batch`` is a dict of tensors on the params' device:
    under the model's mesh this rank's rows (:func:`local_batch`) and
    params (``Model.local_params``)."""
    def train_step(params, opt_state, batch):
        loss, metrics, grads = _lora_grads(model, params, batch,
                                           n_microbatches)
        norm = None
        with torch.no_grad():
            if model.tp is not None:
                loss, metrics, grads, norm = _mesh_mean(model, loss, metrics,
                                                        grads)
            new_lora, new_opt, om = adamw_update(grads, opt_state,
                                                 params["lora"], opt_cfg,
                                                 norm)
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
