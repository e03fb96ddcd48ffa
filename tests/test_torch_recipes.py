"""Port vs reference: per-adapter recipes (``repro_torch.core.fit_recipe``,
``LoRAQuantConfig.for_budget``, the adapter-set helpers) and mixed-recipe
packed serving (``AdapterStore.pack_batch`` building
``PackedLoRABuckets``, ``sgmv_apply_buckets`` through the model) against
``repro.core`` and ``repro.serving`` at the smoke size of llama3.2-3b,
fp32 on the CPU.

QR/SVD signs are free across LAPACK builds, so quantized codes are held
bit-exact against the port's own per-pair path and against the reference
by split ``h``, storage bits and product. Adapters served by both engines
are quantized by JAX and carried across by the bridge, so both serve the
same codes and greedy tokens are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import decaying_lora, smoke_cfg
from repro.core import LoRAQuantConfig as JConfig
from repro.core import loraquant as jl
from repro.kernels.quant_matmul import kernel as jk
from repro.launch.serve import random_trained_lora as j_random_lora
from repro.models import build_model as j_build_model
from repro.serving.engine import AdapterStore as JStore
from repro.serving.engine import MultiLoRAEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.bridge import quantized_adapter, to_torch
from repro_torch.configs import get_config
from repro_torch.core import loraquant as tl
from repro_torch.kernels import PackedLoRABatch, PackedLoRABuckets
from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS, PLAIN_CALLS,
                                               reset_launch_counts)
from repro_torch.models import build_model
from repro_torch.serving import AdapterStore, MultiLoRAEngine, Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


FIELDS = ("ah_codes", "ah_scale", "ah_zero", "bh_codes", "bh_scale",
          "bh_zero", "al_codes", "al_scale", "al_zero", "bl_codes",
          "bl_scale", "bl_zero")
META = ("bits_hi", "group_ah", "group_bh", "group_al", "group_bl", "k", "m",
        "rank", "tile_t", "fold")


def _pairs():
    """Three adapters with well-separated decaying spectra (the reference's
    recipe tests use them), and one of another shape."""
    out = [tuple(np.array(v) for v in decaying_lora(seed=s))
           for s in range(3)]
    out.append(tuple(np.array(v) for v in decaying_lora(m=128, n=320,
                                                        seed=7)))
    return out


def _jax(pairs):
    return [(jnp.asarray(b), jnp.asarray(a)) for b, a in pairs]


def _torch(pairs):
    return [(torch.from_numpy(b), torch.from_numpy(a)) for b, a in pairs]


# --------------------------------------------------------------------------
# budget fitting
# --------------------------------------------------------------------------

@pytest.mark.parametrize("target", [1.0, 1.5, 2.0, 3.0])
def test_fit_recipe_matches_reference(target):
    """The same ``(bits_high, rho)`` as the reference at every target, and
    the same achieved average bits after quantizing under it."""
    pairs = _pairs()[:3]
    jrec = jl.fit_recipe(_jax(pairs), target, base=JConfig(ste_steps=0))
    trec = tl.fit_recipe(_torch(pairs), target,
                         base=tl.LoRAQuantConfig(ste_steps=0))
    assert (trec.bits_high, trec.rho) == (jrec.bits_high, jrec.rho)
    assert trec.ste_steps == 0 and trec.group_size == jrec.group_size
    jq = jl.quantize_lora_pairs(_jax(pairs), jrec)
    tq = tl.quantize_lora_pairs(_torch(pairs), trec)
    assert [q.h for q in tq] == [q.h for q in jq]
    jbits = jl.adapter_avg_bits({str(i): q for i, q in enumerate(jq)})
    tbits = tl.adapter_avg_bits({str(i): q for i, q in enumerate(tq)})
    assert tbits == jbits and abs(tbits - target) <= 0.25


def test_for_budget_on_lora_tree(mixed):
    """``for_budget`` on a whole (layer-stacked) LoRA tree picks the
    reference's recipe; the override fields ride through."""
    jparams = mixed["jparams"]
    tree = j_random_lora(jparams["lora"], jax.random.PRNGKey(3))
    for target in (1.5, 2.0):
        jrec = JConfig.for_budget(tree, target, ste_steps=0)
        trec = tl.LoRAQuantConfig.for_budget(to_torch(tree, "cpu"), target,
                                             ste_steps=0)
        assert (trec.bits_high, trec.rho, trec.ste_steps) == (
            jrec.bits_high, jrec.rho, 0)


def test_pair_bit_costs_are_exact():
    """The storage-bit accounting is integer arithmetic: equal to the
    reference's for every shape and width, and equal to what quantization
    then stores."""
    for m, n, r, bits, group in [(256, 256, 16, 2, 128), (200, 384, 8, 3, 64),
                                 (4096, 96, 16, 4, 128), (5, 7, 2, 2, 128)]:
        assert tl._pair_bit_costs(m, n, r, bits, group) == tuple(
            jl._pair_bit_costs(m, n, r, bits, group))
    b, a = _torch(_pairs()[3:])[0]
    for bits, rho in [(2, 0.5), (3, 0.9), (4, 1.0)]:
        q = tl.quantize_lora(b, a, tl.LoRAQuantConfig(
            rho=rho, bits_high=bits, ste_steps=0))
        hi, lo, denom = tl._pair_bit_costs(b.shape[0], a.shape[1], q.rank,
                                           bits, 128)
        assert q.total_bits() == q.h * hi + (q.rank - q.h) * lo
        assert q.num_params() == denom


def test_quantize_pairs_and_adapter_set():
    """``quantize_lora_pairs`` (shape-bucketed) stores exactly the codes of
    per-pair ``quantize_lora``; against the reference: the same split h,
    storage bits and product; ``adapter_avg_bits`` equal."""
    pairs = _pairs()
    cfg = dict(rho=0.9, bits_high=2, ste_steps=0)
    tq = tl.quantize_lora_pairs(_torch(pairs), tl.LoRAQuantConfig(**cfg))
    jq = jl.quantize_lora_pairs(_jax(pairs), JConfig(**cfg))
    solo = tl.quantize_adapter_set(
        {str(i): p for i, p in enumerate(_torch(pairs))},
        tl.LoRAQuantConfig(**cfg))
    assert list(solo) == ["0", "1", "2", "3"]
    for i, (t, j) in enumerate(zip(tq, jq)):
        for f in ("b_high", "a_high", "b_low", "a_low"):
            for arr in ("codes", "scale", "zero"):
                assert torch.equal(getattr(getattr(t, f), arr),
                                   getattr(getattr(solo[str(i)], f), arr))
        assert (t.h, t.rank, t.total_bits()) == (j.h, j.rank, j.total_bits())
        w = np.asarray(j.delta_w())
        np.testing.assert_allclose(t.delta_w().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert tl.adapter_avg_bits(solo) == jl.adapter_avg_bits(
        {str(i): q for i, q in enumerate(jq)})


# --------------------------------------------------------------------------
# mixed-recipe packed serving
# --------------------------------------------------------------------------

RECIPES = {"user_0": (4, 0.95), "user_1": (3, 0.9)}     # the rest: 2@0.9
PROMPT_LENS = [5, 8, 11, 8, 6, 9]
MAX_NEW = 4


@pytest.fixture(scope="module")
def mixed():
    """Four JAX-quantized adapters under three recipes (three packed
    layouts) in a JAX store and, carried across by the bridge, in the
    port's store; JAX-initialized smoke params on both sides."""
    jcfg = smoke_cfg("llama3.2-3b")
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    trees = {f"user_{i}": j_random_lora(jparams["lora"],
                                        jax.random.PRNGKey(40 + i),
                                        scale=0.05) for i in range(4)}
    jstore.register_many(trees, recipes={
        aid: JConfig(rho=rho, bits_high=bits, ste_steps=0)
        for aid, (bits, rho) in RECIPES.items()})
    tstore = AdapterStore()
    for aid, qa in jstore.quantized.items():
        tstore.register_quantized(aid, quantized_adapter(qa, "cpu"))
    tcfg = dataclasses.replace(get_config("llama3.2-3b", "smoke"),
                               dtype=torch.float32)
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, jstore=jstore,
                tmodel=build_model(tcfg), tparams=to_torch(jparams, "cpu"),
                tstore=tstore)


def _leaves(tree, kinds):
    out = []

    def walk(node):
        if isinstance(node, kinds):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    return out


def _assert_batch_equal(jpb, tpb):
    for f in FIELDS:
        got, want = getattr(tpb, f).numpy(), np.asarray(getattr(jpb, f))
        if "codes" in f:
            got, want = got.astype(np.int64), want.astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in META:
        assert getattr(tpb, f) == getattr(jpb, f), f


def test_pack_batch_mixed_matches_reference(mixed):
    """Buckets in ``sorted`` signature order, their stacks and the
    global → local lookups are bit-exact with the reference's; a uniform
    batch is still a bare ``PackedLoRABatch``."""
    from repro.kernels import PackedLoRABatch as JBatch
    from repro.kernels import PackedLoRABuckets as JBuckets

    ids = ["user_0", "user_1", "user_2", "user_3"]
    jtree = mixed["jstore"].pack_batch(ids, mixed["jparams"]["lora"])
    ttree = mixed["tstore"].pack_batch(ids, mixed["tparams"]["lora"])
    jl_, tl_ = _leaves(jtree, JBuckets), _leaves(ttree, PackedLoRABuckets)
    assert len(tl_) == len(jl_) == 7
    n_layers = mixed["jcfg"].n_layers
    for jb, tb in zip(jl_, tl_):
        assert len(tb.buckets) == len(jb.buckets) == 3
        assert [b.bits_hi for b in tb.buckets] == [2, 3, 4]
        for jlut, tlut in zip(jb.lookups, tb.lookups):
            assert tlut.dtype == torch.int32
            assert tuple(tlut.shape) == (n_layers, len(ids))
            np.testing.assert_array_equal(tlut.numpy(), np.asarray(jlut))
        for jpb, tpb in zip(jb.buckets, tb.buckets):
            _assert_batch_equal(jpb, tpb)
    assert mixed["tstore"].pack_batch(ids, mixed["tparams"]["lora"]) is ttree
    uni = ["user_2", "user_3"]
    jtree = mixed["jstore"].pack_batch(uni, mixed["jparams"]["lora"])
    ttree = mixed["tstore"].pack_batch(uni, mixed["tparams"]["lora"])
    assert not _leaves(ttree, PackedLoRABuckets)
    jb, tb = (_leaves(jtree, JBatch), _leaves(ttree, PackedLoRABatch))
    assert len(tb) == len(jb) == 7
    for j, t in zip(jb, tb):
        _assert_batch_equal(j, t)


def _submit(engine, req_cls, vocab, **kw):
    g = np.random.default_rng(7)
    for rid, n in enumerate(PROMPT_LENS):
        engine.submit(req_cls(
            request_id=rid, adapter_id=f"user_{rid % 4}",
            prompt=g.integers(0, vocab, size=n).astype(np.int32),
            max_new_tokens=MAX_NEW, **kw))


def test_mixed_recipe_serve_matches_reference(mixed):
    """A batch over three recipes, ``mode="packed"``: the reference's greedy
    tokens, the port's ``materialize`` tokens, kept logits within 1e-4 of
    max |logit|, and one ``sgmv_fused`` per bucket per LoRA linear, as the
    reference traces them."""
    vocab = mixed["jcfg"].vocab
    jax.clear_caches()                 # count the reference's traces afresh
    jeng = JEngine(mixed["jmodel"], mixed["jparams"], mixed["jstore"],
                   cache_capacity=64)
    _submit(jeng, JRequest, vocab)
    jk.reset_launch_counts()
    want = {r.request_id: r.output for r in jeng.run(mode="packed")}
    j_counts = dict(jk.LAUNCH_COUNTS)

    teng = MultiLoRAEngine(mixed["tmodel"], mixed["tparams"],
                           mixed["tstore"], cache_capacity=64)
    _submit(teng, Request, vocab, keep_logits=True)
    reset_launch_counts()
    packed = teng.run("packed")
    t_counts = dict(PLAIN_CALLS)
    assert not LAUNCH_COUNTS and mixed["tstore"].fp_resident_bytes() == 0
    _submit(teng, Request, vocab, keep_logits=True)
    mat = teng.run("materialize")
    for p, m in zip(packed, mat):
        np.testing.assert_array_equal(p.output, want[p.request_id])
        np.testing.assert_array_equal(m.output, want[p.request_id])
    tol = 1e-4 * max(np.abs(r.logits).max() for r in packed)
    for p, m in zip(packed, mat):
        np.testing.assert_allclose(p.logits, m.logits, rtol=0, atol=tol)
    # the reference traces one prefill and one decode step (its layers are
    # scanned): 3 buckets x 7 linears each; the port launches per layer
    # and per forward (1 prefill + MAX_NEW - 1 decode steps)
    n_layers = mixed["jcfg"].n_layers
    assert j_counts == {"sgmv_fused": 3 * 7 * 2}
    assert t_counts == {"sgmv_fused": j_counts["sgmv_fused"] // 2
                        * n_layers * MAX_NEW}
