"""Port vs reference: deepseek-v3-671b's configuration, its int8 frozen
expert base, its MoE layer with the shared expert and its multi-head
latent attention (``repro_torch.configs`` / ``models.ffn`` /
``models.attention`` against ``repro``) at the smoke size (d_model 128, 4
heads, MLA ranks 32 / 16, rope 8, nope 16, v 16; 4 experts top-2 of width
64 stored as int8, one shared expert), fp32 on the CPU.

Parameters are initialized by JAX and carried across by the bridge;
packed adapters are quantized by JAX. The int8 codes, their scales and
the dequantized expert weights are held bit for bit; the MoE layer's and
MLA's outputs and caches to fp32 tolerance: ``RTOL`` x max |y| (the two
frameworks round matmuls, rsqrt, cos / sin and softmax differently in the
last bits); the port's ``sgmv_fused`` calls against the reference's
launches. ``DSModels`` and ``trained`` are shared with
``test_torch_deepseek.py``.
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
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import ffn as j_ffn
from repro.serving.engine import AdapterStore as JStore
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS, PLAIN_CALLS,
                                               reset_launch_counts)
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model
from repro_torch.models import ffn as t_ffn
from repro_torch.models.model import _layer_slice
from test_torch_memory import Models, bridge_store

ARCH = "deepseek-v3-671b"
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


def _with_cf(cfg, cf):
    return cfg if cf is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


class DSModels(Models):
    """:class:`Models` at deepseek's smoke size, optionally with another
    capacity factor (cross-mode serving parity is defined drop-free, at a
    factor of at least ``n_experts / top_k``)."""

    def __init__(self, cf=None):
        self.jcfg = _with_cf(smoke_cfg(ARCH), cf)
        self.jmodel = j_build_model(self.jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(0))
        self.tmodel = build_model(_with_cf(dataclasses.replace(
            get_config(ARCH, "smoke"), dtype=torch.float32), cf))
        self.tparams = to_torch(self.jparams, "cpu")
        self._jits = {}


def trained(models, seed):
    return j_random_lora(models.jparams["lora"], jax.random.PRNGKey(seed),
                         scale=0.05)


@pytest.fixture(scope="module")
def models():
    """The smoke model of both packages over JAX's params (bridged), with
    a trained-looking fp adapter so every LoRA linear matters."""
    jcfg = smoke_cfg(ARCH)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jparams = {"base": jparams["base"],
               "lora": j_random_lora(jparams["lora"], jax.random.PRNGKey(3),
                                     scale=0.05)}
    tcfg = dataclasses.replace(get_config(ARCH, "smoke"),
                               dtype=torch.float32)
    return jcfg, jparams, build_model(tcfg), to_torch(jparams, "cpu")


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_config_matches_reference(preset):
    """Field for field, the nested MLA and MoE configs, the MTP head and
    the int8 frozen base included."""
    from repro.configs import get_config as j_get_config

    j, t = j_get_config(ARCH, preset), get_config(ARCH, preset)
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "resolved_head_dim",
              "norm", "post_norm", "rope", "rope_theta", "window",
              "attn_softcap", "logit_softcap", "tie_embeddings",
              "n_codebooks", "vision_stub", "subquadratic", "lora_rank",
              "lora_alpha", "mtp", "base_quant_bits"):
        assert getattr(t, f) == getattr(j, f), (preset, f)
    assert dataclasses.asdict(t.mla) == dataclasses.asdict(j.mla)
    assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
    assert [dataclasses.astuple(b) for b in t.blocks] == \
        [dataclasses.astuple(b) for b in j.blocks]
    assert t.total_layers() == j.total_layers()
    assert t.mtp and t.base_quant_bits == 8 and not t.moe.lora_on_experts


# --------------------------------------------------------------------------
# the int8 frozen expert base
# --------------------------------------------------------------------------

def _experts(jparams, tparams):
    jex = jparams["base"]["groups"][1]["sub_0"]["ffn"]["experts"]
    tex = tparams["base"]["groups"][1]["sub_0"]["ffn"]["experts"]
    return jex, tex


def test_int8_codes_and_scales_bit_exact_after_bridge(models):
    """The bridge carries every expert stack's int8 codes ``(L, E, in,
    out)`` and fp32 per-(expert, out-column) scales ``(L, E, 1, out)``
    across with their dtypes and bits; nothing else in the tree is
    int8."""
    _, jparams, _, tparams = models
    jex, tex = _experts(jparams, tparams)
    for name in ("wg", "wu", "wd"):
        jw, js = np.asarray(jex[name]["w"]), np.asarray(jex[name]["scale"])
        tw, ts = tex[name]["w"], tex[name]["scale"]
        assert tw.dtype == torch.int8 and jw.dtype == np.int8
        assert ts.dtype == torch.float32 and js.dtype == np.float32
        assert tuple(tw.shape) == jw.shape and tuple(ts.shape) == js.shape
        assert ts.shape[-2] == 1 and ts.shape[-1] == tw.shape[-1]
        np.testing.assert_array_equal(tw.numpy(), jw)
        np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                      js.view(np.uint32))
        assert np.abs(jw).max() <= 127 and np.abs(jw).max() > 100
    mtp = tparams["base"]["mtp"]
    assert tuple(mtp["proj"]["w"].shape) == (256, 128)
    assert tuple(mtp["norm"]["w"].shape) == (128,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantized_experts_bit_equal_reference(models, dtype):
    """``w.to(dtype) * scale.to(dtype)``, as the reference computes it, to
    the bit in bf16 and fp32: through :func:`expert_weight` and through
    both packages' ``_expert_ffw`` on identity rows (a product with the
    identity is exact)."""
    _, jparams, _, tparams = models
    jex, tex = _experts(jparams, tparams)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for name in ("wg", "wu", "wd"):
        jleaf = jax.tree_util.tree_map(lambda a: a[0], jex[name])
        tleaf = _layer_slice(tex[name], 0)
        want = jleaf["w"].astype(jdt) * jleaf["scale"].astype(jdt)
        got = t_ffn.expert_weight(tleaf, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(
            got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
            .numpy(),
            np.asarray(want).view(np.int16 if dtype == "bfloat16"
                                  else np.int32))
        e, d_in = tleaf["w"].shape[0], tleaf["w"].shape[1]
        eye = np.broadcast_to(np.eye(d_in, dtype=np.float32),
                              (e, d_in, d_in))
        jy = j_ffn._expert_ffw({name: jleaf}, None, name,
                               jnp.asarray(eye).astype(jdt), 2.0)
        ty = t_ffn._expert_ffw({name: tleaf}, None, name,
                               torch.from_numpy(eye.copy()).to(tdt), 2.0)
        np.testing.assert_array_equal(ty.to(torch.float32).numpy(),
                                      np.asarray(jy.astype(jnp.float32)))
        np.testing.assert_array_equal(ty.to(torch.float32).numpy(),
                                      got.to(torch.float32).numpy())


def test_port_init_quantizes_like_the_reference():
    """The port's own init stores int8 codes of |code| <= 127 with one
    fp32 scale per (expert, out-column), each column reaching 127, and
    the dequantized weight within half a step of a uniform(±1/√in)
    draw."""
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=torch.float32)
    params = build_model(cfg).init(seed=0, device="cpu")
    ex = params["base"]["groups"][1]["sub_0"]["ffn"]["experts"]
    for name, d_in in (("wg", 128), ("wu", 128), ("wd", 64)):
        w, sc = ex[name]["w"], ex[name]["scale"]
        assert w.dtype == torch.int8 and sc.dtype == torch.float32
        assert w.shape[:2] == (2, 4) and sc.shape[-2] == 1
        assert (w.abs().amax(dim=-2) == 127).all()
        deq = t_ffn.expert_weight(ex[name], torch.float32)
        assert deq.abs().max() <= 1 / np.sqrt(d_in) * (1 + 1e-6)
    assert "shared" in params["base"]["groups"][1]["sub_0"]["ffn"]
    assert set(params["lora"]["groups"][1]["sub_0"]["ffn"]) == {
        "router", "shared"}


# --------------------------------------------------------------------------
# the MoE layer with its shared expert
# --------------------------------------------------------------------------

def _ffn_inputs(models, form):
    """Layer 0 of the MoE group on both sides and its LoRA in ``form``:
    none, the trained fp factors, or a packed two-adapter stack with
    batch row b meeting adapter ``1 - b``."""
    pick = lambda tree: tree["groups"][1]["sub_0"]["ffn"]  # noqa: E731
    jb = jax.tree_util.tree_map(lambda a: a[0],
                                pick(models.jparams["base"]))
    tb = _layer_slice(pick(models.tparams["base"]), 0)
    if form == "none":
        return jb, None, tb, None
    if form == "fp":
        jl = pick(trained(models, 3))
        return (jb, jax.tree_util.tree_map(lambda a: a[0], jl), tb,
                _layer_slice(to_torch(jl, "cpu"), 0))
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({f"u{i}": trained(models, 7 + i) for i in range(2)})
    tstore = bridge_store(jstore)
    seg = np.repeat(np.asarray([1, 0], np.int32), 8)  # one prefill tile each
    jl = pick({"groups": [None, models.jmodel._attach_seg(
        jstore.pack_batch(["u0", "u1"], models.jparams["lora"])["groups"][1],
        jnp.asarray(seg), 2)]})
    tl = pick({"groups": [None, models.tmodel._attach_seg(
        tstore.pack_batch(["u0", "u1"], models.tparams["lora"])["groups"][1],
        torch.from_numpy(seg))]})
    return (jb, jax.tree_util.tree_map(lambda a: a[0], jl), tb,
            _layer_slice(tl, 0))


@pytest.mark.parametrize("form", ["none", "fp", "packed"])
@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_moe_ffn_with_shared_expert_matches_reference(form, cf):
    """``moe_ffn`` (int8 experts without LoRA, the router and the shared
    expert with it) against the reference, with capacity drops (cf 1.25)
    and drop-free (cf 2 = E / top_k): output and aux loss; the packed form
    reaches ``sgmv_fused`` as often as the reference launches it (the
    router and the shared expert's three linears)."""
    models = DSModels(cf=cf)
    jb, jl, tb, tl = _ffn_inputs(models, form)
    x = np.random.default_rng(5).normal(size=(2, 8, 128)).astype(np.float32)
    jk.reset_launch_counts()
    with jax.disable_jit():
        jax.make_jaxpr(lambda xx: j_ffn.moe_ffn(
            xx, jb, jl, models.jcfg, scaling=2.0))(jnp.asarray(x))
    j_counts = dict(jk.LAUNCH_COUNTS)
    wy, waux = j_ffn.moe_ffn(jnp.asarray(x), jb, jl, models.jcfg,
                             scaling=2.0)
    reset_launch_counts()
    ty, taux = t_ffn.moe_ffn(torch.from_numpy(x), tb, tl, models.tmodel.cfg,
                             scaling=2.0)
    assert dict(PLAIN_CALLS) == j_counts
    assert not LAUNCH_COUNTS
    assert PLAIN_CALLS["sgmv_fused"] == (4 if form == "packed" else 0)
    _close(ty, wy)
    _close(taux, waux)
    # the shared expert is not a no-op: without it the output moves
    mc = dataclasses.replace(models.tmodel.cfg.moe, n_shared=0)
    alone, _ = t_ffn.moe_ffn(torch.from_numpy(x), tb, tl, dataclasses.replace(
        models.tmodel.cfg, moe=mc), scaling=2.0)
    assert (alone - ty).abs().max() > 100 * RTOL * ty.abs().max()


# --------------------------------------------------------------------------
# multi-head latent attention
# --------------------------------------------------------------------------

def _mla_layer(models, gi=0):
    """Layer 0 of group ``gi``'s MLA params and fp LoRA on both sides."""
    _, jparams, _, tparams = models
    pick = lambda tree: tree["groups"][gi]["sub_0"]["mixer"]  # noqa: E731
    jb = jax.tree_util.tree_map(lambda a: a[0], pick(jparams["base"]))
    jl = jax.tree_util.tree_map(lambda a: a[0], pick(jparams["lora"]))
    return (jb, jl, _layer_slice(pick(tparams["base"]), 0),
            _layer_slice(pick(tparams["lora"]), 0))


def _inputs(b, t, seed=5):
    x = np.random.default_rng(seed).normal(size=(b, t, 128)).astype(
        np.float32)
    start = np.asarray([0, 3, 1][:b], np.int32)
    ar = np.arange(t)[None, :]
    pad = ar >= start[:, None]
    pos = np.maximum(ar - start[:, None], 0).astype(np.int32)
    return x, start, pad, pos


@pytest.mark.parametrize("blockwise", [False, True])
def test_mla_sequence_mode_matches_reference(models, blockwise):
    """Sequence mode over left-padded rows (``pad_mask``): the plain path
    (its own einsum, scores over the 24-wide qk head dim) and the
    blockwise one (v padded to the qk width, chunks of 4 keys)."""
    jcfg = models[0]
    jb, jl, tb, tl = _mla_layer(models)
    x, _, pad, pos = _inputs(3, 11)
    kw = dict(force_blockwise=blockwise, kv_chunk=4)
    want, _ = j_attn.mla_attention(jnp.asarray(x), jb, jl, jcfg,
                                   positions=jnp.asarray(pos),
                                   pad_mask=jnp.asarray(pad), **kw)
    got = t_attn.mla_attention(torch.from_numpy(x), tb, tl, models[2].cfg,
                               positions=torch.from_numpy(pos).long(),
                               pad_mask=torch.from_numpy(pad), **kw)
    _close(got, want)


def test_mla_blockwise_equals_plain_in_the_port(models):
    """The port's two sequence paths agree on every real token (a pad
    query has no key to attend to, and each path fills it its own way, as
    the reference's do), and the default below the threshold is the plain
    one."""
    _, _, tb, tl = _mla_layer(models)
    x, _, pad, pos = _inputs(2, 13, seed=8)
    cfg = models[2].cfg
    args = (torch.from_numpy(x), tb, tl, cfg)
    kw = dict(positions=torch.from_numpy(pos).long(),
              pad_mask=torch.from_numpy(pad))
    plain = t_attn.mla_attention(*args, force_blockwise=False, **kw)
    block = t_attn.mla_attention(*args, force_blockwise=True, kv_chunk=4,
                                 **kw)
    default = t_attn.mla_attention(*args, **kw)
    assert torch.equal(default, plain)
    real = torch.from_numpy(pad)
    torch.testing.assert_close(block[real], plain[real], rtol=0,
                               atol=RTOL * plain.abs().max().item())


def test_mla_prefill_and_absorbed_decode_match_reference(models):
    """A prefill into a linear cache of capacity 12 (the last min(T, cap)
    latents at slots [0, keep)), then absorbed decode steps with per-row
    ``cache_pos`` / ``valid_start``; one row runs past the capacity, so
    its write is clamped to the last slot as in the reference. Outputs,
    and the ``c`` / ``kr`` caches, equal the reference's."""
    jcfg = models[0]
    tcfg = models[2].cfg
    jb, jl, tb, tl = _mla_layer(models, gi=1)
    x, start, pad, pos = _inputs(3, 10, seed=6)
    cap = 12
    jcache = j_attn.init_mla_cache(jcfg, 3, cap, jnp.float32)
    tcache = {k: v[0] for k, v in t_attn.init_mla_cache(
        tcfg, 3, cap, torch.float32, "cpu", count=1).items()}
    want, jcache = j_attn.mla_attention(
        jnp.asarray(x), jb, jl, jcfg, positions=jnp.asarray(pos),
        cache=jcache, cache_pos=0, pad_mask=jnp.asarray(pad))
    got = t_attn.mla_attention(
        torch.from_numpy(x), tb, tl, tcfg,
        positions=torch.from_numpy(pos).long(), cache=tcache,
        cache_pos=torch.zeros((3,), dtype=torch.int64),
        pad_mask=torch.from_numpy(pad))
    _close(got, want)
    # row 2 starts two slots ahead, so it reaches capacity and beyond
    cur = np.asarray([10, 10, 11], np.int32)
    g = np.random.default_rng(9)
    for step in range(4):
        xs = g.normal(size=(3, 1, 128)).astype(np.float32)
        rpos = (cur - start)[:, None]
        want, jcache = j_attn.mla_attention(
            jnp.asarray(xs), jb, jl, jcfg, positions=jnp.asarray(rpos),
            cache=jcache, cache_pos=jnp.asarray(cur),
            valid_start=jnp.asarray(start))
        got = t_attn.mla_attention(
            torch.from_numpy(xs), tb, tl, tcfg,
            positions=torch.from_numpy(rpos).long(), cache=tcache,
            cache_pos=torch.from_numpy(cur).long(),
            valid_start=torch.from_numpy(start).long())
        _close(got, want)
        for name in ("c", "kr"):
            _close(tcache[name], jcache[name])
        cur = cur + 1
    assert cur[2] > cap                      # the clamp was exercised
    assert tuple(tcache["c"].shape) == (3, cap, 16)
    assert tuple(tcache["kr"].shape) == (3, cap, 8)


def test_mla_init_and_cache_shapes_match_reference(models):
    """The port's own MLA init has the reference's leaves, shapes and
    dtypes (LoRA on wq_down, wq_up, wkv_down, wo only) and its caches
    are ``{"c", "kr"}`` per group."""
    jcfg, jparams, tmodel, _ = models
    tparams = tmodel.init(seed=0, device="cpu")

    def shapes(tree):
        out = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}/{k}")
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, f"{path}/{i}")
            else:
                out[path] = (tuple(node.shape), str(node.dtype).split(".")[-1])
        walk(tree, "")
        return out

    assert shapes(tparams) == shapes(jparams)
    assert set(tparams["lora"]["groups"][0]["sub_0"]["mixer"]) == {
        "wq_down", "wq_up", "wkv_down", "wo"}
    jc = j_build_model(jcfg).init_cache(2, 16)
    tc = tmodel.init_cache(2, 16, device="cpu")
    assert shapes(tc) == shapes(jc)
