"""Port vs reference: the multi-LoRA serving engine's static modes
(``repro_torch.serving`` against ``repro.serving``) at the smoke size of
llama3.2-3b, fp32 on the CPU.

Greedy tokens are compared exactly: adapters quantized by JAX are carried
across by the bridge, so both engines serve the same codes, and JAX's
Pallas kernel runs with ``interpret=True``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.core import LoRAQuantConfig as JConfig
from repro.launch.serve import random_trained_lora as j_random_lora
from repro.models import build_model as j_build_model
from repro.serving.engine import AdapterStore as JStore
from repro.serving.engine import MultiLoRAEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.bridge import quantized_adapter, to_torch
from repro_torch.configs import get_config
from repro_torch.core import LoRAQuantConfig
from repro_torch.kernels.quant_matmul import PLAIN_CALLS, reset_launch_counts
from repro_torch.launch.serve import random_trained_lora
from repro_torch.models import build_model
from repro_torch.serving import (AdapterStore, AdapterValidationError,
                                 MultiLoRAEngine, Request, RequestStatus,
                                 UnknownAdapter)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


PROMPT_LENS = [5, 8, 11, 8]
MAX_NEW = [4, 2, 4, 4]


def _prompts(vocab, seed=7):
    g = np.random.default_rng(seed)
    return [g.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


def _submit(engine, req_cls, prompts, n_adapters=3, **kw):
    for rid, p in enumerate(prompts):
        engine.submit(req_cls(request_id=rid, adapter_id=f"u{rid % n_adapters}",
                              prompt=p, max_new_tokens=MAX_NEW[rid], **kw))


@pytest.fixture(scope="module")
def served():
    """JAX model + three JAX-quantized adapters with different split h, and
    the port's engine over the same params and codes."""
    jcfg = smoke_cfg("llama3.2-3b")
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    for i in range(3):
        jstore.register(f"u{i}", j_random_lora(
            jparams["lora"], jax.random.PRNGKey(40 + i), scale=0.05))
    tcfg = dataclasses.replace(get_config("llama3.2-3b", "smoke"),
                               dtype=torch.float32)
    tstore = AdapterStore()
    for aid, qa in jstore.quantized.items():
        tstore.register_quantized(aid, quantized_adapter(qa, "cpu"))
    return jcfg, jmodel, jparams, jstore, build_model(tcfg), \
        to_torch(jparams, "cpu"), tstore


def test_packed_tokens_match_reference_engine(served):
    jcfg, jmodel, jparams, jstore, tmodel, tparams, tstore = served
    hs = {q.h for qa in jstore.quantized.values()
          for qs in qa.entries.values() for q in qs}
    assert len(hs) > 1                      # heterogeneous split indices
    prompts = _prompts(jcfg.vocab)
    jeng = JEngine(jmodel, jparams, jstore, cache_capacity=64)
    _submit(jeng, JRequest, prompts)
    want = {r.request_id: r.output for r in jeng.run(mode="packed")}

    teng = MultiLoRAEngine(tmodel, tparams, tstore, cache_capacity=64)
    _submit(teng, Request, prompts)
    reset_launch_counts()
    got = {r.request_id: r.output for r in teng.run()}
    # 2 layers x 7 LoRA linears per forward, 1 prefill + 3 decode forwards
    assert PLAIN_CALLS["sgmv_fused"] == 2 * 7 * 4
    assert tstore.fp_resident_bytes() == 0      # never dequantized
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert len(got[1]) == 2                      # early finisher kept length

    _submit(teng, Request, prompts)
    mat = {r.request_id: r.output for r in teng.run(mode="materialize")}
    assert tstore.fp_resident_bytes() > 0
    for rid in want:
        np.testing.assert_array_equal(mat[rid], want[rid])


def test_port_quantized_packed_equals_materialize():
    """Adapters quantized by the port itself (3-bit high side, STE refine)
    serve the same tokens from packed codes and from fp trees."""
    cfg = dataclasses.replace(get_config("llama3.2-3b", "smoke"),
                              dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    store = AdapterStore(LoRAQuantConfig(rho=0.9, bits_high=3, ste_steps=20))
    gen = torch.Generator().manual_seed(5)
    store.register_many({f"u{i}": random_trained_lora(params["lora"], gen,
                                                      scale=0.05)
                         for i in range(3)})
    assert 1.0 < store.stats()["avg_bits"] < 3.5
    engine = MultiLoRAEngine(model, params, store, cache_capacity=32)
    prompts = _prompts(cfg.vocab, seed=3)
    _submit(engine, Request, prompts)
    packed = {r.request_id: r.output for r in engine.run("packed")}
    _submit(engine, Request, prompts)
    mat = {r.request_id: r.output for r in engine.run("materialize")}
    for rid in packed:
        np.testing.assert_array_equal(packed[rid], mat[rid])


def test_kept_logits_packed_equal_materialize(served):
    """Per-step logits kept on the requests agree across the two modes to
    fp32 rounding (1e-4 of max |logit|), while serving each prompt with
    another adapter moves them by far more: the comparison sees the LoRA
    update of every row."""
    jcfg, *_, tmodel, tparams, tstore = served
    engine = MultiLoRAEngine(tmodel, tparams, tstore, cache_capacity=64)
    prompts = _prompts(jcfg.vocab)
    runs = {}
    for mode, n_adapters in (("packed", 3), ("materialize", 3),
                             ("packed", 2)):
        _submit(engine, Request, prompts, n_adapters, keep_logits=True)
        runs[mode, n_adapters] = engine.run(mode)
    for r in runs["packed", 3]:
        assert r.logits.shape == (len(r.output), jcfg.vocab)
        assert r.logits.dtype == np.float32
    logits = {k: [r.logits for r in v] for k, v in runs.items()}
    tol = 1e-4 * max(np.abs(x).max() for x in logits["packed", 3])
    for got, want in zip(logits["packed", 3], logits["materialize", 3]):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # requests 2 and 3 meet another adapter when there are two
    for rid in (2, 3):
        moved = np.abs(logits["packed", 2][rid]
                       - logits["packed", 3][rid]).max()
        assert moved > 10 * tol, (rid, moved, tol)
    _submit(engine, Request, prompts[:1])
    assert engine.run("packed")[0].logits is None


def test_engine_failure_contract(served):
    *_, tmodel, tparams, tstore = served
    with pytest.raises(NotImplementedError, match="A7"):
        MultiLoRAEngine(tmodel, tparams, tstore, mode="continuous")
    engine = MultiLoRAEngine(tmodel, tparams, tstore, cache_capacity=32)
    r = engine.submit(Request(request_id=0, adapter_id="nobody",
                              prompt=np.arange(4, dtype=np.int32)))
    assert r.status is RequestStatus.REJECTED
    assert isinstance(r.error, UnknownAdapter) and r.output.shape == (0,)
    assert engine.pending == []
    bad = {"groups": [{"sub_0": {"mixer": {"wq": {
        "a": torch.full((2, 16, 128), float("nan")),
        "b": torch.zeros((2, 128, 16))}}}}]}
    store = AdapterStore()
    with pytest.raises(AdapterValidationError, match="non-finite"):
        store.register("bad", bad)
    store.register_many({"bad": bad}, on_error="skip")
    assert "bad" in store.onboard_errors and not store.quantized


def test_mixed_recipes_and_unregister(served):
    *_, tmodel, tparams, tstore = served
    store = AdapterStore()
    for aid in ("u0", "u1"):
        store.register_quantized(aid, tstore.quantized[aid])
    store.register_quantized("u2", dataclasses.replace(
        tstore.quantized["u2"], recipe=LoRAQuantConfig(bits_high=4)))
    with pytest.raises(NotImplementedError, match="A4"):
        store.pack_batch(["u0", "u2"], tparams["lora"])
    store.pack_batch(["u0", "u1"], tparams["lora"])
    assert store.packed_cache_bytes() > 0
    store.unregister("u1")
    assert store.version("u1") is None and store.packed_cache_bytes() > 0
    engine = MultiLoRAEngine(tmodel, tparams, store, cache_capacity=32)
    r = engine.submit(Request(request_id=1, adapter_id="u1",
                              prompt=np.arange(4, dtype=np.int32)))
    assert r.status is RequestStatus.REJECTED


def test_serve_driver_smoke_cpu():
    from repro_torch.launch.serve import main

    done = main(["--device", "cpu", "--adapters", "2", "--requests", "3",
                 "--prompt-len", "6", "--max-new", "2"])
    assert len(done) == 3
    assert all(r.status is RequestStatus.DONE and r.output.shape == (2,)
               for r in done)
