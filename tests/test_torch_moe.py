"""Port vs reference: the sparse-MoE feed-forward and the mixtral-8x22b
model and serve (``repro_torch.models.ffn`` / ``model`` / ``serving``
against ``repro``) at the smoke size of mixtral-8x22b (2 layers, d_model
128, 4 experts top-2, window 8), fp32 on the CPU.

Parameters are initialized by JAX and carried across by the bridge;
adapters are quantized by JAX, so both packages serve the same codes, and
the reference runs its Pallas kernels in interpret mode. Expert routing is
held exactly (the dispatch indices bit for bit), the outputs to fp32
tolerance, greedy tokens and the paging sequence exactly, and the port's
``sgmv_fused`` calls against the reference's launches.
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
from repro.models import ffn as j_ffn
from repro.serving.engine import AdapterStore as JStore
from repro.serving.engine import MultiLoRAEngine as JEngine
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS, PLAIN_CALLS,
                                               reset_launch_counts)
from repro_torch.models import build_model
from repro_torch.models import ffn as t_ffn
from repro_torch.models.model import _layer_slice
from repro_torch.serving import MultiLoRAEngine
from test_torch_continuous import _count_reference, _lockstep
from test_torch_faults import ROOT, load
from test_torch_memory import (Models, assert_pools_equal, bridge_store,
                               requests, trace_paging)

ARCH = "mixtral-8x22b"
# LoRA linears per layer: wq wk wv wo, the router, and wg wu wd of the
# experts (one launch each over all experts' rows)
LINEARS = 8
# fp32 outputs of a 2-layer model or one MoE layer, relative to max |y|:
# the two frameworks round matmuls, rsqrt, exp and softmax differently in
# the last bits
RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


class MoEModels(Models):
    """:class:`Models` at mixtral's smoke size, optionally with another
    capacity factor (drop-free serving parity needs one of at least
    ``n_experts``, as the reference's own tests set it)."""

    def __init__(self, cf=None):
        jcfg, tcfg = smoke_cfg(ARCH), dataclasses.replace(
            get_config(ARCH, "smoke"), dtype=torch.float32)
        if cf is not None:
            jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, capacity_factor=cf))
            tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
                tcfg.moe, capacity_factor=cf))
        self.jcfg, self.jmodel = jcfg, j_build_model(jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(0))
        self.tmodel = build_model(tcfg)
        self.tparams = to_torch(self.jparams, "cpu")
        self._jits = {}


@pytest.fixture(scope="module")
def models():
    return MoEModels()


@pytest.fixture(scope="module")
def dropfree():
    return MoEModels(cf=4.0)


def _trained(models, seed):
    return j_random_lora(models.jparams["lora"], jax.random.PRNGKey(seed),
                         scale=0.05)


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

def test_config_matches_reference():
    from repro.configs import get_config as j_get_config

    for preset in ("full", "smoke"):
        j, t = j_get_config(ARCH, preset), get_config(ARCH, preset)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "resolved_head_dim",
                  "rope_theta", "window", "subquadratic", "lora_rank",
                  "lora_alpha", "tie_embeddings", "norm", "rope"):
            assert getattr(t, f) == getattr(j, f), (preset, f)
        assert [dataclasses.astuple(b) for b in t.blocks] == \
            [dataclasses.astuple(b) for b in j.blocks]
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
    assert get_config(ARCH).window == 4096
    assert get_config("rwkv6-1.6b").blocks[0].pattern == ("rwkv",)


# --------------------------------------------------------------------------
# routing and dispatch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [1, 3, 8, 100])
def test_dispatch_indices_bit_exact(capacity):
    ids = np.random.default_rng(capacity).integers(0, 4, 40).astype(np.int32)
    want = j_ffn._dispatch_indices(jnp.asarray(ids), 4, capacity)
    got = t_ffn._dispatch_indices(torch.from_numpy(ids).long(), 4, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                        [0.3, 0.2, 0.3, 0.2]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(probs), 2)
    gv, gi = t_ffn._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _ffn_inputs(models, form, seq=(1, 0)):
    """Layer 0's MoE params of both packages and its LoRA in ``form``:
    none, the trained fp factors, a packed two-adapter stack (one recipe)
    or two layout buckets (two recipes), with rows of batch row b meeting
    adapter ``seq[b]``."""
    jb = jax.tree_util.tree_map(
        lambda a: a[0], models.jparams["base"]["groups"][0]["sub_0"]["ffn"])
    tb = _layer_slice(models.tparams["base"]["groups"][0]["sub_0"]["ffn"], 0)
    if form == "none":
        return jb, None, tb, None
    if form == "fp":
        jl = _trained(models, 3)["groups"][0]["sub_0"]["ffn"]
        return (jb, jax.tree_util.tree_map(lambda a: a[0], jl), tb,
                _layer_slice(to_torch(jl, "cpu"), 0))
    recipes = ({"u1": JConfig(rho=0.95, bits_high=4, ste_steps=0)}
               if form == "buckets" else {})
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({f"u{i}": _trained(models, 7 + i) for i in range(2)},
                         recipes=recipes)
    tstore = bridge_store(jstore)
    ids = ["u0", "u1"]
    seg = np.repeat(np.asarray(seq, np.int32), 8)   # one prefill tile each
    jl = models.jmodel._attach_seg(
        jstore.pack_batch(ids, models.jparams["lora"])["groups"][0],
        jnp.asarray(seg), 2)["sub_0"]["ffn"]
    tl = models.tmodel._attach_seg(
        tstore.pack_batch(ids, models.tparams["lora"])["groups"][0],
        torch.from_numpy(seg))["sub_0"]["ffn"]
    return (jb, jax.tree_util.tree_map(lambda a: a[0], jl), tb,
            _layer_slice(tl, 0))


@pytest.mark.parametrize("form", ["none", "fp", "packed", "buckets"])
@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_ffn_matches_reference(form, cf):
    """``moe_ffn``'s output and aux loss against the reference's, with
    capacity drops (cf 1.25) and drop-free (cf 4 = n_experts), for every
    LoRA form; packed forms reach ``sgmv_fused`` exactly as often as the
    reference launches it (router plus three expert linears, per
    bucket)."""
    models = MoEModels(cf=cf)
    jb, jl, tb, tl = _ffn_inputs(models, form)
    x = np.random.default_rng(5).normal(size=(2, 8, 128)).astype(np.float32)
    assert t_ffn.moe_capacity(16, models.tmodel.cfg.moe) == max(
        int(np.ceil(16 * 2 / 4 * cf)), 8)
    jk.reset_launch_counts()
    with jax.disable_jit():
        jax.make_jaxpr(lambda xx: j_ffn.moe_ffn(
            xx, jb, jl, models.jcfg, scaling=2.0))(jnp.asarray(x))
    j_counts = dict(jk.LAUNCH_COUNTS)
    wy, waux = j_ffn.moe_ffn(jnp.asarray(x), jb, jl, models.jcfg, scaling=2.0)
    reset_launch_counts()
    ty, taux = t_ffn.moe_ffn(torch.from_numpy(x), tb, tl, models.tmodel.cfg,
                             scaling=2.0)
    assert dict(PLAIN_CALLS) == j_counts
    assert not LAUNCH_COUNTS
    launches = {"none": 0, "fp": 0, "packed": 4, "buckets": 8}[form]
    assert PLAIN_CALLS["sgmv_fused"] == launches
    _close(ty, wy)
    _close(taux, waux)


def test_drops_are_the_reference_drops(models):
    """With cf 1.25 a skewed batch overflows an expert: the dropped
    assignments, and so the outputs, are the reference's."""
    jb, _, tb, _ = _ffn_inputs(models, "none")
    g = np.random.default_rng(9)
    x = np.repeat(g.normal(size=(1, 1, 128)), 12, axis=1).astype(np.float32)
    x += 1e-3 * g.normal(size=x.shape).astype(np.float32)
    xf = jnp.asarray(x).reshape(12, -1)
    top = np.asarray(jax.lax.top_k(jax.nn.softmax(xf @ jb["router"]["w"]),
                                   2)[1])
    assert np.bincount(top.ravel(), minlength=4).max() > 8    # cap 8
    wy, _ = j_ffn.moe_ffn(jnp.asarray(x), jb, None, models.jcfg)
    ty, _ = t_ffn.moe_ffn(torch.from_numpy(x), tb, None, models.tmodel.cfg)
    _close(ty, wy)
    assert (np.abs(np.asarray(wy)).reshape(12, -1).max(1) == 0).any()


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_smoke_model_prefill_and_decode_match_reference(models):
    """Left-padded prefill and three decode steps of the smoke model with a
    trained fp adapter: logits to fp32 tolerance, greedy tokens equal."""
    jp = {"base": models.jparams["base"], "lora": _trained(models, 3)}
    tp = to_torch(jp, "cpu")
    g = np.random.default_rng(0)
    toks = g.integers(0, models.jcfg.vocab, (2, 12)).astype(np.int32)
    start = np.asarray([0, 3], np.int32)
    jl, jc = models.jmodel.prefill(jp, {"tokens": jnp.asarray(toks),
                                        "start": jnp.asarray(start)}, 32)
    tl, tc = models.tmodel.prefill(tp, {"tokens": torch.from_numpy(toks),
                                        "start": torch.from_numpy(start)}, 32)
    _close(tl, jl)
    assert tc[0]["sub_0"]["k"].shape[2] == models.jcfg.window  # ring of 8
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy()[:, None],
                                      nxt)
        pos = np.full((2,), 12 + step, np.int32)
        jl, jc = models.jmodel.decode_step(jp, jnp.asarray(nxt), jc,
                                           jnp.asarray(pos),
                                           jnp.asarray(start))
        tl, tc = models.tmodel.decode_step(tp, torch.from_numpy(nxt), tc,
                                           torch.from_numpy(pos),
                                           torch.from_numpy(start))
        _close(tl, jl)
    _close(tc[0]["sub_0"]["k"], jc[0]["sub_0"]["k"])


def test_eight_lora_linears_per_layer(models):
    """The reference's LoRA tree has 8 linears per layer (each stacked over
    the layers): the count every launch check here and on the card uses;
    the port's template has the same paths and shapes."""
    from repro.serving.engine import iter_lora_linears as j_iter
    from repro_torch.serving.engine import iter_lora_linears as t_iter

    jpaths = {p: tuple(leaf["a"].shape)
              for p, leaf in j_iter(models.jparams["lora"])}
    assert len(jpaths) == LINEARS
    assert sorted(p.rsplit("/", 1)[-1] for p in jpaths) == sorted(
        ["wq", "wk", "wv", "wo", "router", "wg", "wu", "wd"])
    tparams = models.tmodel.init(seed=0, device="cpu")
    assert {p: tuple(leaf["a"].shape)
            for p, leaf in t_iter(tparams["lora"])} == jpaths


def test_model_rejects_unported_layers():
    """A layer kind neither package has raises ``ValueError`` naming it in
    both inits, as the reference's ``_init_mixer`` / ``_init_ffn`` do."""
    for field, kind in (("pattern", "ssm"), ("ffn", "swiglu_moe")):
        cfg, jcfg = get_config(ARCH, "smoke"), smoke_cfg(ARCH)
        cfg, jcfg = (dataclasses.replace(c, blocks=(dataclasses.replace(
            c.blocks[0], **{field: (kind,)}),)) for c in (cfg, jcfg))
        with pytest.raises(ValueError, match=kind):
            build_model(cfg).init(device="cpu")
        with pytest.raises(ValueError, match=kind):
            j_build_model(jcfg).init(jax.random.PRNGKey(0))


# --------------------------------------------------------------------------
# serving: tests/test_serving.py and tests/test_recipes.py mirrored
# --------------------------------------------------------------------------

def _moe_reqs(models, seq, max_new, seed=3, plen=8):
    return requests(models.jcfg.vocab, seq, seed=seed, max_new=max_new,
                    plen=plen)


def _count_forwards(tmodel):
    """Patch the port model to record its forwards; returns the list and
    an undo."""
    seen = []
    orig = tmodel.prefill, tmodel.decode_step

    def wrap(fn):
        def call(params, *a, **kw):
            leaf = params["lora"]["groups"][0]["sub_0"]["mixer"]["wq"]
            seen.append(len(getattr(leaf, "buckets", (leaf,))))
            return fn(params, *a, **kw)
        return call

    tmodel.prefill, tmodel.decode_step = wrap(orig[0]), wrap(orig[1])

    def undo():
        del tmodel.prefill, tmodel.decode_step
    return seen, undo


@pytest.mark.parametrize("recipes", ["uniform", "mixed"])
def test_moe_packed_serve_matches_reference(dropfree, recipes):
    """``tests/test_serving.py::test_moe_extra_lead_dims_packed_parity`` and
    ``tests/test_recipes.py::test_moe_mixed_recipe_packed_parity``: per-
    expert adapters served continuously from packed codes (the expert axis
    folded into the adapter axis, bucket-locally when two recipes mix),
    the reference's tokens step by step, its launches, and the port's own
    materialize reference."""
    models = dropfree
    rec = ({"u0": JConfig(rho=0.9, bits_high=2, ste_steps=0),
            "u1": JConfig(rho=0.95, bits_high=4, ste_steps=0)}
           if recipes == "mixed" else {})
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({f"u{i}": _trained(models, 7 + i) for i in range(2)},
                         recipes=rec)
    assert any(len(q.shape) == 4 for q in jax.tree_util.tree_leaves(
        jstore.quantized["u0"].template))
    tstore = bridge_store(jstore)
    jeng, teng = models.engines(jstore, tstore, capacity=32)
    jcounts = _count_reference(models, jeng, 32)
    jreqs, treqs = _moe_reqs(models, ["u0", "u1", "u0"], max_new=3)
    seen, undo = _count_forwards(models.tmodel)
    reset_launch_counts()
    try:
        _, tdone = _lockstep(jeng, teng, jreqs, treqs)
    finally:
        undo()
    assert tstore.fp_resident_bytes() == 0        # served from packed codes
    assert dict(PLAIN_CALLS) == jcounts == {
        "sgmv_fused": 2 * LINEARS * sum(seen)}
    mat = MultiLoRAEngine(models.tmodel, models.tparams, tstore,
                          cache_capacity=32, mode="materialize")
    for r in _moe_reqs(models, ["u0", "u1", "u0"], max_new=3)[1]:
        mat.submit(r)
    ref = {r.request_id: r.output for r in mat.run()}
    assert tstore.fp_resident_bytes() > 0
    for r in tdone:
        np.testing.assert_array_equal(r.output, ref[r.request_id])


def test_moe_bounded_continuous_paging_matches_reference(models):
    """A Zipf-like stream over 5 adapters through 2 rows and 2 device
    slots with the config's own capacity factor (drops included): the
    reference's tokens, every ``acquire`` / ``prefetch`` of its paging,
    its stats and its pools ``(L, slots·E, Rp, ·)`` bit for bit."""
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({f"u{i}": _trained(models, 20 + i)
                          for i in range(5)})
    tstore = bridge_store(jstore)
    jeng, teng = models.engines(jstore, tstore, capacity=32, max_rows=2,
                                hbm_slots=2)
    jlog, tlog = trace_paging(jeng.memory), trace_paging(teng.memory)
    seq = ["u0", "u1", "u0", "u2", "u3", "u0", "u4", "u1"]
    jreqs, treqs = _moe_reqs(models, seq, max_new=3, seed=11)
    _lockstep(jeng, teng, jreqs, treqs)
    assert tlog == jlog and any(e[0] == "acquire" for e in tlog)
    st = teng.memory_stats()
    assert st == jeng.memory_stats() and st["evictions"] > 0
    assert_pools_equal(jeng.memory, teng.memory)
    pool = next(iter(teng.memory._pools.values()))
    wg = pool.arrays["/groups/0/sub_0/ffn/experts/wg"]["ah_codes"]
    assert wg.shape[:2] == (2, 2 * 4)             # (L, slots·E, ...)


def test_serve_driver_mixtral_smoke(capsys):
    """``serve.py --arch mixtral-8x22b`` at the smoke preset, one row at a
    time: bounded to 1 slot (every adapter change evicts) it gives the
    all-resident run's tokens, one ``sgmv_fused`` per LoRA linear per
    forward. (With the config's capacity drops a token's expert can depend
    on the rows batched with it, so both runs keep one row; the multi-row
    parity is held against the reference above.)"""
    from repro_torch.launch import serve

    common = ["--arch", "mixtral-8x22b", "--preset", "smoke", "--device",
              "cpu", "--adapters", "3", "--requests", "4", "--prompt-len",
              "6", "--max-new", "3", "--max-rows", "1"]
    reset_launch_counts()
    bounded = serve.main(common + ["--slots", "1"])
    # 4 requests x (1 prefill + 2 decode steps), 2 layers x 8 linears
    assert dict(PLAIN_CALLS) == {"sgmv_fused": 4 * 3 * 2 * LINEARS}
    out = capsys.readouterr().out
    assert "1 slots in 1 pool(s)" in out and "evictions 0" not in out
    resident = serve.main(common)
    assert len(bounded) == len(resident) == 4
    got = {r.request_id: r.output.tolist() for r in bounded}
    for r in resident:
        assert len(r.output) == 3 and got[r.request_id] == r.output.tolist()


def test_chip_smoke_moe_phases_rehearse_on_the_cpu():
    """``chip_smoke.py``'s phases 19-21 at the smoke size on the CPU (the
    plain versions in place of the kernels): the continuous MoE serve with
    the reference's paging and 2 layers x 8 launches per forward, the
    drop-free routing / token / logit parity with its control, and the
    long prompt (past the window) with the blockwise attention check."""
    chip_smoke = load("chip_smoke", ROOT / "chip_smoke.py")
    cont = chip_smoke.phase_moe_continuous("cpu", "smoke")
    assert cont["launches"] == 2 * LINEARS * 24       # 3 groups + 21 steps
    parity = chip_smoke.phase_moe_parity("cpu", "smoke")
    assert parity["gap"] <= parity["tol"]
    long = chip_smoke.phase_moe_long("cpu", "smoke")
    assert long["gap"] <= long["tol"] and long["attn_err_None"] < 1e-5
