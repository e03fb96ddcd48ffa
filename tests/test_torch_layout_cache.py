"""The padded kernel layout of a layer-stacked ``QuantizedLoRA`` leaf is
built once per leaf and served to every layer and every step from there
(``ops._qlora_layout`` / ``ops.qlora_layer``), instead of being rebuilt in
front of every ``fused_lora`` call; the outputs are bit for bit those of
the per-call build. Smoke-size llama3.2-3b on the CPU, no JAX."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import LoRAQuantConfig, quantize_lora
from repro_torch.kernels.quant_matmul import lora_apply_quantized, ops
from repro_torch.models import build_model
from repro_torch.models import model as model_mod

STEPS = 3                     # decode steps after the prefill


def _stack(ts):
    return dataclasses.replace(ts[0], **{
        f: torch.stack([getattr(t, f) for t in ts])
        for f in ("codes", "scale", "zero")})


def _stacked_qlora(leaf, rng, rho):
    """One layer-stacked ``QuantizedLoRA`` for an ``{'a', 'b'}`` leaf: per
    layer an adapter with one decaying spectrum (one split h), quantized
    ``2@rho`` without refinement, stacked array by array."""
    n_layers, r, k = leaf["a"].shape
    m = leaf["b"].shape[1]
    s = np.exp(-0.4 * np.arange(r))
    qls = []
    for _ in range(n_layers):
        u = np.linalg.qr(rng.normal(size=(m, r)))[0]
        v = np.linalg.qr(rng.normal(size=(k, r)))[0]
        b = torch.from_numpy((u * np.sqrt(s)).astype(np.float32))
        a = torch.from_numpy((np.sqrt(s)[:, None] * v.T).astype(np.float32))
        qls.append(quantize_lora(b, a, LoRAQuantConfig(
            rho=rho, bits_high=2, refine="none")))
    assert len({q.h for q in qls}) == 1
    q0 = qls[0]
    low = q0.a_low is not None
    return dataclasses.replace(
        q0, b_high=_stack([q.b_high for q in qls]),
        a_high=_stack([q.a_high for q in qls]),
        b_low=_stack([q.b_low for q in qls]) if low else None,
        a_low=_stack([q.a_low for q in qls]) if low else None)


def _tree(node, rng, rho):
    if isinstance(node, dict) and set(node) == {"a", "b"}:
        return _stacked_qlora(node, rng, rho)
    if isinstance(node, dict):
        return {k: _tree(v, rng, rho) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree(v, rng, rho) for v in node)
    return node


def _leaves(node):
    if isinstance(node, ops.QuantizedLoRA):
        return [node]
    if isinstance(node, dict):
        return [q for v in node.values() for q in _leaves(v)]
    if isinstance(node, (list, tuple)):
        return [q for v in node for q in _leaves(v)]
    return []


def _serve(model, params, toks):
    """Prefill + STEPS greedy decode steps; every step's logits."""
    logits, caches = model.prefill(params, {"tokens": toks}, 16)
    out = [logits]
    nxt = logits[:, -1].argmax(-1)[:, None]
    for step in range(STEPS):
        pos = torch.full((toks.shape[0],), toks.shape[1] + step,
                         dtype=torch.int64)
        logits, caches = model.decode_step(params, nxt, caches, pos)
        out.append(logits)
        nxt = logits[:, -1].argmax(-1)[:, None]
    return out


@pytest.mark.parametrize("rho", [0.9, 1.0])
def test_stacked_leaf_layout_built_once_and_bit_identical(monkeypatch, rho):
    cfg = dataclasses.replace(get_config("llama3.2-3b", "smoke"),
                              dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
    builds = collections.Counter()
    real_layout = ops._kernel_layout

    def counted(q, pad_r=None):
        builds[id(q)] += 1
        return real_layout(q, pad_r)

    monkeypatch.setattr(ops, "_kernel_layout", counted)

    def run(per_call_layout: bool):
        """Serve a fresh copy of the tree; ``per_call_layout`` hands each
        layer a plain ``index(i)`` entry, so every call builds its layout
        (the behaviour before the cache)."""
        tree = _tree(params["lora"], np.random.default_rng(7), rho)
        with monkeypatch.context() as mp:
            if per_call_layout:
                mp.setattr(model_mod, "qlora_layer", lambda q, i: q.index(i))
            builds.clear()
            logits = _serve(model, {"base": params["base"], "lora": tree},
                            toks)
        return logits, sum(builds.values()), tree

    cached, n_cached, tree = run(per_call_layout=False)
    fresh, n_fresh, _ = run(per_call_layout=True)
    for got, want in zip(cached, fresh):
        assert torch.equal(got, want)
    leaves = _leaves(tree)
    sides = sum(4 if q.a_low is not None else 2 for q in leaves)
    assert all((q.a_low is None) == (rho == 1.0) for q in leaves)
    # once per side of every stacked leaf, over prefill + STEPS decode steps
    assert n_cached == sides
    assert n_fresh == sides * cfg.n_layers * (1 + STEPS)


def test_layer_entry_carries_the_stacked_layout():
    """``qlora_layer`` hands layer i the same entry every time, carrying
    views of the stacked leaf's layout equal to the layer's own 2-D
    layout."""
    rng = np.random.default_rng(11)
    leaf = {"a": torch.zeros(3, 16, 256), "b": torch.zeros(3, 200, 16)}
    q = _stacked_qlora(leaf, rng, 0.9)
    for i in range(3):
        layer = ops.qlora_layer(q, i)
        assert ops.qlora_layer(q, i) is layer
        own = [ops._kernel_layout(s)[:3] for s in ops._sides_of(q.index(i))]
        for got, want in zip(ops._qlora_layout(layer), own):
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        x = torch.from_numpy(rng.normal(size=(5, 256)).astype(np.float32))
        torch.testing.assert_close(
            lora_apply_quantized(x, layer, scaling=2.0),
            lora_apply_quantized(x, q.index(i), scaling=2.0), rtol=0, atol=0)


def test_layout_entry_dropped_with_its_leaf():
    """The layouts live in ``ops._LAYOUTS`` only as long as their leaf: a
    stacked leaf and its per-layer entries leave it when the leaf goes, and
    a ``dataclasses.replace`` copy builds its own."""
    import gc

    rng = np.random.default_rng(5)
    leaf = {"a": torch.zeros(2, 16, 256), "b": torch.zeros(2, 128, 16)}
    q = _stacked_qlora(leaf, rng, 0.9)
    before = len(ops._LAYOUTS)
    layers = [ops.qlora_layer(q, i) for i in range(2)]
    assert len(ops._LAYOUTS) == before + 3
    copy = dataclasses.replace(q)
    assert ops._qlora_layout(copy) is not ops._qlora_layout(q)
    for got, want in zip(ops._qlora_layout(copy), ops._qlora_layout(q)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    del q, layers, copy
    gc.collect()
    assert len(ops._LAYOUTS) == before
