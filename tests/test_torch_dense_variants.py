"""Port vs reference: the dense variants (ROADMAP A6a) at their smoke
sizes, fp32 on the CPU: olmo-1b (non-parametric LayerNorm), internlm2-20b
(plain GQA) and musicgen-medium (codebook embeddings and heads, served at
the model level only: ROADMAP C8). ``tests/test_torch_model.py`` holds the
configs of all seven ported architectures; ``tests/test_torch_gemma2.py``
and ``tests/test_torch_qwen2_vl.py`` hold the other two dense variants and
import the helpers here.

Parameters are initialized by JAX and carried across by the bridge;
adapters are quantized by JAX, packed by both packages from the same codes
and applied through ``sgmv_fused`` (the reference's Pallas kernel in
interpret mode), so the logits are held to fp32 tolerance and the port's
plain ``sgmv_fused`` calls to the reference's launches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.core import LoRAQuantConfig as JConfig
from repro.kernels.quant_matmul import kernel as jk
from repro.launch.serve import random_trained_lora as j_random_lora
from repro.models import build_model as j_build_model
from repro.serving.engine import AdapterStore as JStore
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS, PLAIN_CALLS,
                                               reset_launch_counts)
from repro_torch.models import build_model
from test_torch_memory import Models, bridge_store

# fp32 logits of a 2-layer model: the two frameworks round matmuls, rsqrt,
# cos/sin, tanh and softmax differently in the last bits; relative to
# max |logit|
LOGIT_RTOL = 2e-5
LINEARS = 7                  # wq wk wv wo wg wu wd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------------------------------
# shared helpers (also used by test_torch_gemma2.py, test_torch_qwen2_vl.py)
# --------------------------------------------------------------------------

class DenseModels(Models):
    """:class:`Models` (the reference model and the port's over the same
    bridged params, shared reference jits) for any ported arch at its
    smoke size."""

    def __init__(self, arch):
        self.jcfg = smoke_cfg(arch)
        self.jmodel = j_build_model(self.jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(0))
        self.tmodel = build_model(dataclasses.replace(
            get_config(arch, "smoke"), dtype=torch.float32))
        self.tparams = to_torch(self.jparams, "cpu")
        self._jits = {}

    @property
    def layers(self) -> int:
        return self.jcfg.total_layers()

    def trained(self, seed):
        return j_random_lora(self.jparams["lora"], jax.random.PRNGKey(seed),
                             scale=0.05)

    def stores(self, n=2, seed=7):
        """``n`` trained adapters ``u0..`` quantized by the reference
        (``2@0.9``) and the port's store over the same codes."""
        jstore = JStore(JConfig(rho=0.9, ste_steps=0))
        jstore.register_many({f"u{i}": self.trained(seed + i)
                              for i in range(n)})
        return jstore, bridge_store(jstore)


def close(got, want, rtol=LOGIT_RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def reference_launches(fn):
    """The reference's kernel launches of ``fn()`` with its layer scan
    unrolled (traced once under ``jax.disable_jit``)."""
    before = dict(jk.LAUNCH_COUNTS)
    with jax.disable_jit():
        jax.make_jaxpr(fn)()
    return {k: v - before.get(k, 0) for k, v in jk.LAUNCH_COUNTS.items()
            if v != before.get(k, 0)}


def _packed(models, jstore, tstore, ids, rows, tile_t):
    """Both packages' LoRA trees over ``ids`` with per-row adapter ``rows``
    (seg ids, each repeated to fill its prompt's tiles)."""
    jl = jstore.pack_batch(ids, models.jparams["lora"], tile_t=tile_t)
    tl = tstore.pack_batch(ids, models.tparams["lora"], tile_t=tile_t)
    return ({"base": models.jparams["base"],
             "lora": {"groups": jl["groups"], "seg": jnp.asarray(rows)}},
            {"base": models.tparams["base"],
             "lora": {"groups": tl["groups"],
                      "seg": torch.from_numpy(rows)}})


def next_tokens(logits):
    """Greedy next tokens of the last position: ``(B, 1)``, or ``(B, K,
    1)`` from codebook logits ``(B, K, T, V)``."""
    return np.asarray(jnp.argmax(logits[..., -1, :], -1))[..., None].astype(
        np.int32)


def packed_model_parity(models, batch, extra=None, n_decode=3, capacity=32):
    """Prefill ``batch`` (numpy; ``extra`` adds model inputs such as
    ``vision_embeds`` or ``positions``) and ``n_decode`` greedy decode
    steps through both packages with a two-adapter packed LoRA tree (row
    b meets adapter b mod 2): logits within ``LOGIT_RTOL`` of max |logit|,
    greedy tokens equal, and exactly the reference's ``sgmv_fused``
    launches (one per LoRA linear per layer per forward). Returns the last
    logits of both."""
    jstore, tstore = models.stores()
    toks = batch["tokens"]
    b = toks.shape[0]
    aidx = (np.arange(b) % 2).astype(np.int32)
    extra = extra or {}
    t_all = toks.shape[-1] + (extra["vision_embeds"].shape[1]
                              if "vision_embeds" in extra else 0)
    jp, tp = _packed(models, jstore, tstore, ["u0", "u1"],
                     np.repeat(aidx, t_all), 8)
    jb = {k: jnp.asarray(v) for k, v in {**batch, **extra}.items()}
    tb = {k: torch.from_numpy(v) for k, v in {**batch, **extra}.items()}
    want = {"sgmv_fused": models.layers * LINEARS}
    jcounts = reference_launches(
        lambda: models.jmodel.prefill(jp, jb, capacity))
    jl, jc = models.jmodel.prefill(jp, jb, capacity)
    reset_launch_counts()
    tl, tc = models.tmodel.prefill(tp, tb, capacity)
    assert dict(PLAIN_CALLS) == jcounts == want and not LAUNCH_COUNTS
    close(tl, jl)
    jd, td = _packed(models, jstore, tstore, ["u0", "u1"], aidx, 1)
    start = batch.get("start")
    for step in range(n_decode):
        nxt = next_tokens(jl)
        np.testing.assert_array_equal(next_tokens(tl.numpy()), nxt)
        pos = np.full((b,), t_all + step, np.int32)
        args = (jnp.asarray(pos),) + (() if start is None
                                      else (jnp.asarray(start),))
        targs = (torch.from_numpy(pos),) + (() if start is None
                                            else (torch.from_numpy(start),))
        jcounts = reference_launches(
            lambda: models.jmodel.decode_step(jd, jnp.asarray(nxt), jc,
                                              *args))
        jl, jc = models.jmodel.decode_step(jd, jnp.asarray(nxt), jc, *args)
        reset_launch_counts()
        tl, tc = models.tmodel.decode_step(td, torch.from_numpy(nxt), tc,
                                           *targs)
        assert dict(PLAIN_CALLS) == jcounts == want
        close(tl, jl)
    return tl, jl


def continuous_parity(models, seq, *, plen=10, max_new=4, slots=2, rows=2,
                      capacity=32, seed=3):
    """``seq``'s requests through both packages' continuous engines in
    lock-step (``rows`` rows over ``slots`` device slots of three
    adapters): the same requests finish in the same steps with the same
    greedy tokens, the same paging, and the port's ``sgmv_fused`` calls
    equal to the reference's launches (one per LoRA linear per layer per
    forward). Returns the port's finished requests."""
    from test_torch_continuous import _count_reference, _lockstep
    from test_torch_memory import requests, trace_paging

    jstore, tstore = models.stores(n=3, seed=20)
    jeng, teng = models.engines(jstore, tstore, capacity=capacity,
                                max_rows=rows, hbm_slots=slots)
    jcounts = _count_reference(models, jeng, capacity)
    jlog, tlog = trace_paging(jeng.memory), trace_paging(teng.memory)
    jreqs, treqs = requests(models.jcfg.vocab, seq, seed=seed,
                            max_new=max_new, plen=plen)
    reset_launch_counts()
    _, tdone = _lockstep(jeng, teng, jreqs, treqs)
    forwards = teng._wave + teng._step_count
    assert dict(PLAIN_CALLS) == jcounts == {
        "sgmv_fused": models.layers * LINEARS * forwards}
    assert tlog == jlog and teng.memory_stats() == jeng.memory_stats()
    return tdone


# --------------------------------------------------------------------------
# olmo-1b and internlm2-20b: left-padded prefill and decode, packed
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmo():
    return DenseModels("olmo-1b")


@pytest.fixture(scope="module")
def internlm2():
    return DenseModels("internlm2-20b")


def _prompts(models, b=2, t=16, seed=0):
    g = np.random.default_rng(seed)
    return {"tokens": g.integers(0, models.jcfg.vocab, (b, t)).astype(
        np.int32), "start": np.asarray([0, 5], np.int32)[:b]}


def test_olmo_norms_are_empty_dicts(olmo):
    sub = olmo.tparams["base"]["groups"][0]["sub_0"]
    assert sub["mixer_norm"] == {} and sub["ffn_norm"] == {}
    assert olmo.tparams["base"]["final_norm"] == {}
    assert "head" not in olmo.tparams["base"]              # tied table
    mine = olmo.tmodel.init(seed=0, device="cpu")["base"]
    assert mine["groups"][0]["sub_0"]["mixer_norm"] == {}
    assert set(mine) == set(olmo.tparams["base"])


@pytest.mark.parametrize("arch", ["olmo", "internlm2"])
def test_packed_prefill_and_decode_match_reference(arch, olmo, internlm2):
    models = {"olmo": olmo, "internlm2": internlm2}[arch]
    packed_model_parity(models, _prompts(models))


def test_olmo_continuous_engine_tokens_match_reference(olmo):
    """The engine over a model whose norms carry no weight."""
    continuous_parity(olmo, ["u0", "u1", "u2", "u1"], plen=9, max_new=3)


def test_fp_lora_prefill_matches_reference(olmo):
    """The fp LoRA path (no kernel) through olmo's LayerNorm."""
    jp = {"base": olmo.jparams["base"], "lora": olmo.trained(3)}
    tp = to_torch(jp, "cpu")
    batch = _prompts(olmo, seed=4)
    jl, _ = olmo.jmodel.prefill(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, 32)
    reset_launch_counts()
    tl, _ = olmo.tmodel.prefill(tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, 32)
    assert not PLAIN_CALLS
    close(tl, jl)


# --------------------------------------------------------------------------
# musicgen-medium: (B, K, T) tokens at the model level; C8
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def musicgen():
    return DenseModels("musicgen-medium")


def test_musicgen_codebook_tables_cross_the_bridge(musicgen):
    cfg = musicgen.jcfg
    for name in ("embed", "head"):
        e = musicgen.tparams["base"][name]["e"]
        assert e.shape == (cfg.n_codebooks, cfg.vocab, cfg.d_model)
        np.testing.assert_array_equal(
            e.numpy(), np.asarray(musicgen.jparams["base"][name]["e"]))
    mine = musicgen.tmodel.init(seed=0, device="cpu")["base"]
    assert mine["head"]["e"].shape == (cfg.n_codebooks, cfg.vocab,
                                       cfg.d_model)


def test_musicgen_packed_codebook_logits_match_reference(musicgen):
    """``(B, 4, T)`` prompts, logits ``(B, 4, T, V)``, decode ``(B, 4,
    1)`` tokens per step."""
    g = np.random.default_rng(5)
    cfg = musicgen.jcfg
    toks = g.integers(0, cfg.vocab, (2, cfg.n_codebooks, 8)).astype(np.int32)
    tl, jl = packed_model_parity(musicgen, {"tokens": toks})
    assert tl.shape == (2, cfg.n_codebooks, 1, cfg.vocab)


def test_musicgen_rejected_through_the_engine_by_both_packages(musicgen):
    """ROADMAP C8: both engines hand the model ``(B, T)`` tokens at
    prefill; musicgen embeds ``(B, K, T)``. The reference crashes in its
    attention (``not enough values to unpack``), the port's model refuses
    the shape naming C8, and the port's serve driver refuses the arch
    before it builds anything."""
    from repro.launch import serve as j_serve
    from repro.serving.engine import MultiLoRAEngine as JEngine
    from repro.serving.engine import Request as JRequest
    from repro_torch.launch import serve as t_serve
    from repro_torch.serving import MultiLoRAEngine, Request

    jstore, tstore = musicgen.stores(n=1)
    prompt = np.arange(8, dtype=np.int32)
    jeng = JEngine(musicgen.jmodel, musicgen.jparams, jstore,
                   cache_capacity=16)
    jeng.submit(JRequest(request_id=0, adapter_id="u0", prompt=prompt,
                         max_new_tokens=2))
    with pytest.raises(ValueError, match="not enough values to unpack"):
        jeng.step()
    teng = MultiLoRAEngine(musicgen.tmodel, musicgen.tparams, tstore,
                           cache_capacity=16)
    teng.submit(Request(request_id=0, adapter_id="u0", prompt=prompt,
                        max_new_tokens=2))
    with pytest.raises(ValueError, match="C8"):
        teng.step()
    with pytest.raises(ValueError, match="C8"):
        t_serve.main(["--arch", "musicgen-medium", "--device", "cpu"])
    with pytest.raises(ValueError, match="not enough values to unpack"):
        j_serve.main(["--arch", "musicgen-medium", "--preset", "smoke",
                      "--adapters", "1", "--requests", "1", "--prompt-len",
                      "8", "--max-new", "2"])
