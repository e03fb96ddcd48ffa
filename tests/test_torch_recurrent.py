"""Port vs reference: the recurrent mixers (``repro_torch.models.recurrent``
against ``repro.models.recurrent``) at the smoke sizes of rwkv6-1.6b
(d_model 128, 2 heads of 64, d_ff 256) and recurrentgemma-2b (RG-LRU
width 128, conv width 4), fp32 on the CPU.

Parameters are initialized by JAX and carried across by the bridge; the
parameters the init leaves constant (RWKV's bonus, mixing coefficients and
group-norm bias, the conv bias) are perturbed on the JAX side first, and
the LoRA factors are a trained-looking adapter, so every term matters.
Quantized and packed LoRA leaves are quantized by JAX, whose kernels run in
interpret mode. Held: outputs and states within ``RTOL`` x max |y| (fp32
sums and transcendental functions rounded differently in the last bits),
the bf16 conv state bit for bit, init trees leaf for leaf, and the port's
kernel calls against the reference's launches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.core import LoRAQuantConfig as JConfig
from repro.core import quantize_lora as j_quantize_lora
from repro.kernels.quant_matmul import kernel as jk
from repro.launch.serve import random_trained_lora as j_random_lora
from repro.models import build_model as j_build_model
from repro.models import recurrent as j_rec
from repro.serving.engine import AdapterStore as JStore
from repro_torch.bridge import quantized_lora, to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS, PLAIN_CALLS,
                                               reset_launch_counts)
from repro_torch.models import build_model
from repro_torch.models import recurrent as t_rec
from repro_torch.models.model import _layer_slice
from test_torch_memory import bridge_store

RWKV, RG = "rwkv6-1.6b", "recurrentgemma-2b"
# fp32 outputs relative to max |y|: matmuls, exp / log, tanh, rsqrt and
# the chunk sums are rounded differently in the last bits
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
    got = (got.detach().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _perturb(tree, rng):
    """The init's constant leaves replaced by random values of the same
    shape (so a wrong bonus, mix or bias shows)."""
    spread = {"bonus": ("normal", 0.5), "mu": ("uniform", 1.0),
              "mu_base": ("uniform", 1.0), "mu_k": ("uniform", 1.0),
              "mu_r": ("uniform", 1.0), "gn_w": ("normal", 0.3),
              "gn_b": ("normal", 0.1), "conv_b": ("normal", 0.1)}

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k in spread:
                kind, s = spread[k]
                a = (rng.uniform(0, s, v.shape) if kind == "uniform"
                     else rng.normal(0, s, v.shape))
                if k == "gn_w":
                    a = a + 1.0
                out[k] = jnp.asarray(a.astype(np.float32))
            else:
                out[k] = walk(v)
        return out

    return walk(tree)


class Arch:
    """One smoke model of both packages over JAX's params (bridged), with
    the constant leaves perturbed and a trained-looking fp adapter."""

    def __init__(self, arch):
        self.jcfg = smoke_cfg(arch)
        self.jmodel = j_build_model(self.jcfg)
        raw = self.jmodel.init(jax.random.PRNGKey(0))
        self.template = raw["lora"]
        base = _perturb(raw["base"], np.random.default_rng(7))
        self.jparams = {"base": base, "lora": j_random_lora(
            raw["lora"], jax.random.PRNGKey(3), scale=0.05)}
        self.tcfg = dataclasses.replace(get_config(arch, "smoke"),
                                        dtype=torch.float32)
        self.tmodel = build_model(self.tcfg)
        self.tparams = to_torch(self.jparams, "cpu")

    def layer(self, part, sub=0, lora=None):
        """Layer 0 of group 0's sub-block ``sub``, ``part`` ("mixer" /
        "ffn"): ``(jax base, jax lora, port base, port lora)`` (``lora``
        overrides the trained fp adapter with a tree of both packages)."""
        pick = lambda t: t["groups"][0][f"sub_{sub}"][part]  # noqa: E731
        jl, tl = lora or (self.jparams["lora"], self.tparams["lora"])
        one = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)  # noqa
        return (one(pick(self.jparams["base"])), one(pick(jl)),
                _layer_slice(pick(self.tparams["base"]), 0),
                _layer_slice(pick(tl), 0))


@pytest.fixture(scope="module")
def rwkv():
    return Arch(RWKV)


@pytest.fixture(scope="module")
def rg():
    return Arch(RG)


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _state_close(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _state_close(got[k], want[k])
        else:
            assert got[k].dtype == getattr(torch, str(want[k].dtype))
            _close(got[k], want[k])


# --------------------------------------------------------------------------
# RWKV-6
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prev", [False, True])
def test_token_shift_and_projections_match_reference(rwkv, prev):
    """``_token_shift`` (zeros or the carried ``x_prev`` before step 0)
    exactly, and ``_rwkv_projections``' r, k, v, g and decay w."""
    jb, jl, tb, tl = rwkv.layer("mixer")
    x = _x((2, 9, 128))
    xp = _x((2, 1, 128), 1) if prev else None
    jxp = None if xp is None else jnp.asarray(xp)
    txp = None if xp is None else torch.from_numpy(xp)
    np.testing.assert_array_equal(
        t_rec._token_shift(torch.from_numpy(x), txp).numpy(),
        np.asarray(j_rec._token_shift(jnp.asarray(x), jxp)))
    want = j_rec._rwkv_projections(jnp.asarray(x), jb, jl, 2.0, jxp)
    got = t_rec._rwkv_projections(torch.from_numpy(x), tb, tl, 2.0, txp)
    for g, w in zip(got, want):
        _close(g, w)
    w = got[-1]
    assert ((w > 0) & (w < 1)).all()


@pytest.mark.parametrize("t", [16, 32, 64, 128])
@pytest.mark.parametrize("chunk", [16, 64])
def test_rwkv_tmix_sequence_matches_reference(rwkv, t, chunk):
    """The chunked scan (one to eight chunks, the block factorization with
    ``sub = 16``) from a zero and from a carried state: output and the
    state at the end."""
    jb, jl, tb, tl = rwkv.layer("mixer")
    x = _x((2, t, 128), t + chunk)
    want, jnone = j_rec.rwkv_tmix(jnp.asarray(x), jb, jl, rwkv.jcfg,
                                  chunk=chunk)
    got, tnone = t_rec.rwkv_tmix(torch.from_numpy(x), tb, tl, rwkv.tcfg,
                                 chunk=chunk)
    assert jnone is None and tnone is None
    _close(got, want)
    state = {"x_prev": _x((2, 1, 128), 3),
             "s": _x((2, 2, 64, 64), 4, 0.3)}
    want, jst = j_rec.rwkv_tmix(
        jnp.asarray(x), jb, jl, rwkv.jcfg, chunk=chunk,
        state={k: jnp.asarray(v) for k, v in state.items()})
    got, tst = t_rec.rwkv_tmix(
        torch.from_numpy(x), tb, tl, rwkv.tcfg, chunk=chunk,
        state={k: torch.from_numpy(v) for k, v in state.items()})
    _close(got, want)
    _state_close(tst, jst)


def test_rwkv_tmix_decode_matches_reference(rwkv):
    """One recurrence step (T = 1) from a random state: output, the new
    ``s`` and ``x_prev``."""
    jb, jl, tb, tl = rwkv.layer("mixer")
    x = _x((3, 1, 128), 5)
    state = {"x_prev": _x((3, 1, 128), 6), "s": _x((3, 2, 64, 64), 7, 0.3)}
    want, jst = j_rec.rwkv_tmix(
        jnp.asarray(x), jb, jl, rwkv.jcfg,
        state={k: jnp.asarray(v) for k, v in state.items()})
    got, tst = t_rec.rwkv_tmix(
        torch.from_numpy(x), tb, tl, rwkv.tcfg,
        state={k: torch.from_numpy(v) for k, v in state.items()})
    _close(got, want)
    _state_close(tst, jst)


def test_rwkv_state_carried_from_prefill_into_decode(rwkv):
    """A 32-token prefill with a state and 8 decode steps through both
    packages, each step against the reference; the port's steps also equal
    its own sequence forward of all 40 tokens (chunk 8)."""
    jb, jl, tb, tl = rwkv.layer("mixer")
    x = _x((2, 40, 128), 8)
    zeros = {"x_prev": np.zeros((2, 1, 128), np.float32),
             "s": np.zeros((2, 2, 64, 64), np.float32)}
    jst = {k: jnp.asarray(v) for k, v in zeros.items()}
    tst = {k: torch.from_numpy(v) for k, v in zeros.items()}
    jout, jst = j_rec.rwkv_tmix(jnp.asarray(x[:, :32]), jb, jl, rwkv.jcfg,
                                state=jst)
    tout, tst = t_rec.rwkv_tmix(torch.from_numpy(x[:, :32]), tb, tl,
                                rwkv.tcfg, state=tst)
    _close(tout, jout)
    steps = [tout]
    for i in range(32, 40):
        jout, jst = j_rec.rwkv_tmix(jnp.asarray(x[:, i:i + 1]), jb, jl,
                                    rwkv.jcfg, state=jst)
        tout, tst = t_rec.rwkv_tmix(torch.from_numpy(x[:, i:i + 1]), tb, tl,
                                    rwkv.tcfg, state=tst)
        _close(tout, jout)
        _state_close(tst, jst)
        steps.append(tout)
    whole, _ = t_rec.rwkv_tmix(torch.from_numpy(x), tb, tl, rwkv.tcfg,
                               chunk=8)
    _close(torch.cat(steps, dim=1), whole.numpy())


def test_rwkv_chunk_must_divide_the_sequence(rwkv):
    """T = 72 with chunk 64: both packages raise the same ``ValueError``
    (ROADMAP C10); T = 48 at chunk 16 runs."""
    jb, jl, tb, tl = rwkv.layer("mixer")
    x = _x((1, 72, 128), 9)
    with pytest.raises(ValueError, match="divisible by chunk 64"):
        j_rec.rwkv_tmix(jnp.asarray(x), jb, jl, rwkv.jcfg, chunk=64)
    with pytest.raises(ValueError, match="seq len 72 must be divisible by "
                                         "chunk 64"):
        t_rec.rwkv_tmix(torch.from_numpy(x), tb, tl, rwkv.tcfg, chunk=64)
    out, _ = t_rec.rwkv_tmix(torch.from_numpy(x[:, :48]), tb, tl, rwkv.tcfg,
                             chunk=16)
    assert out.shape == (1, 48, 128)


@pytest.mark.parametrize("mode", ["sequence", "carried", "decode"])
def test_rwkv_cmix_matches_reference(rwkv, mode):
    """The channel mix without a state, with a carried ``x_prev`` over 12
    tokens, and at one decode step."""
    jb, jl, tb, tl = rwkv.layer("ffn")
    t = 1 if mode == "decode" else 12
    x = _x((2, t, 128), 10)
    jst = tst = None
    if mode != "sequence":
        xp = _x((2, 1, 128), 11)
        jst, tst = {"x_prev": jnp.asarray(xp)}, {
            "x_prev": torch.from_numpy(xp)}
    want, jnew = j_rec.rwkv_cmix(jnp.asarray(x), jb, jl, rwkv.jcfg,
                                 state=jst)
    got, tnew = t_rec.rwkv_cmix(torch.from_numpy(x), tb, tl, rwkv.tcfg,
                                state=tst)
    _close(got, want)
    assert (jnew is None) == (tnew is None) == (mode == "sequence")
    if tnew is not None:
        np.testing.assert_array_equal(tnew["x_prev"].numpy(),
                                      np.asarray(jnew["x_prev"]))


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_reference(rg, with_prev):
    """The depthwise conv's taps summed in order in fp32, with zeros or a
    carried window before step 0: output and the fp32 conv state."""
    jb, _, tb, _ = rg.layer("mixer")
    y = _x((2, 11, 128), 12)
    prev = _x((2, 3, 128), 13) if with_prev else None
    want, jstate = j_rec._causal_conv(
        jnp.asarray(y), jb["conv_w"], jb["conv_b"],
        None if prev is None else jnp.asarray(prev))
    got, tstate = t_rec._causal_conv(
        torch.from_numpy(y), tb["conv_w"], tb["conv_b"],
        None if prev is None else torch.from_numpy(prev))
    _close(got, want)
    assert tstate.dtype == torch.float32
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))


@pytest.mark.parametrize("t", [1, 7, 33, 64])
def test_associative_scan_matches_reference(t):
    """The odd / even recursion of ``jax.lax.associative_scan`` with the
    RG-LRU combine at odd and even lengths, against JAX's scan and the
    plain sequential recurrence."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.2, 1.0, (2, t, 16)).astype(np.float32)
    b = rng.normal(size=(2, t, 16)).astype(np.float32)

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2

    wa, wb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ga, gb = t_rec.associative_scan(t_rec._lru_combine,
                                    [torch.from_numpy(a),
                                     torch.from_numpy(b)], dim=1)
    _close(ga, wa)
    _close(gb, wb)
    h, seq = np.zeros((2, 16), np.float32), []
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        seq.append(h)
    _close(gb, np.stack(seq, 1), 1e-5)


@pytest.mark.parametrize("mode", ["sequence", "sequence_h0", "decode"])
def test_rglru_block_matches_reference(rg, mode):
    """``rglru_block`` over 13 tokens without a state and with a carried
    ``h0`` and conv window (folded into step 0), and one decode step:
    output and new state."""
    jb, jl, tb, tl = rg.layer("mixer")
    t = 1 if mode == "decode" else 13
    x = _x((2, t, 128), 14)
    jst = tst = None
    if mode != "sequence":
        st = {"h": _x((2, 128), 15), "conv": _x((2, 3, 128), 16)}
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
    want, jnew = j_rec.rglru_block(jnp.asarray(x), jb, jl, rg.jcfg,
                                   state=jst)
    got, tnew = t_rec.rglru_block(torch.from_numpy(x), tb, tl, rg.tcfg,
                                  state=tst)
    _close(got, want)
    assert (jnew is None) == (tnew is None) == (mode == "sequence")
    if tnew is not None:
        _state_close(tnew, jnew)


def test_rglru_prefill_then_decode_equals_sequence(rg):
    """A 9-token prefill with a state and 5 decode steps of the port equal
    its own sequence forward of 14 tokens (the conv window and ``h``
    carried)."""
    _, _, tb, tl = rg.layer("mixer")
    x = torch.from_numpy(_x((2, 14, 128), 17))
    whole, _ = t_rec.rglru_block(x, tb, tl, rg.tcfg)
    st = {k: v[0] for k, v in t_rec.init_rglru_state(
        rg.tcfg, 2, "cpu").items()}
    outs = []
    out, st = t_rec.rglru_block(x[:, :9], tb, tl, rg.tcfg, state=st)
    outs.append(out)
    for i in range(9, 14):
        out, st = t_rec.rglru_block(x[:, i:i + 1], tb, tl, rg.tcfg, state=st)
        outs.append(out)
    _close(torch.cat(outs, 1), whole.numpy())


def test_bf16_conv_state_rounded_like_the_reference(rg):
    """In bf16 the conv runs in fp32 and its output and state are rounded
    to bf16, bit for bit as the reference rounds them; ``rglru_block``
    returns the state in the input's dtype."""
    jb, _, tb, _ = rg.layer("mixer")
    y = _x((2, 6, 128), 18, 3.0)
    prev = _x((2, 3, 128), 19, 3.0)
    jy, jp = jnp.asarray(y).astype(jnp.bfloat16), jnp.asarray(prev).astype(
        jnp.bfloat16)
    ty, tp = torch.from_numpy(y).bfloat16(), torch.from_numpy(prev).bfloat16()
    want, jstate = j_rec._causal_conv(jy, jb["conv_w"], jb["conv_b"], jp)
    got, tstate = t_rec._causal_conv(ty, tb["conv_w"], tb["conv_b"], tp)
    assert got.dtype == torch.bfloat16
    bits = lambda a: np.asarray(a).view(np.uint16)  # noqa: E731
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), bits(want))
    np.testing.assert_array_equal(
        tstate.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16),
        bits(jstate.astype(jnp.bfloat16)))
    bcfg = dataclasses.replace(rg.tcfg, dtype=torch.bfloat16)
    tb16 = {k: ({"w": v["w"].bfloat16()} if k in ("w_in", "w_gate", "w_out")
                else v) for k, v in tb.items()}
    x = torch.from_numpy(_x((2, 1, 128), 20)).bfloat16()
    st = {"h": torch.zeros(2, 128), "conv": tp}
    _, new = t_rec.rglru_block(x, tb16, None, bcfg, state=st)
    assert new["conv"].dtype == torch.bfloat16
    assert new["h"].dtype == torch.float32
    np.testing.assert_array_equal(new["conv"][:, :2].float().numpy(),
                                  tp[:, 1:].float().numpy())


# --------------------------------------------------------------------------
# the LoRA forms: quantized (fused_lora) and packed multi-adapter (sgmv)
# --------------------------------------------------------------------------

MODULES = {"tmix": (RWKV, "mixer", 0), "cmix": (RWKV, "ffn", 0),
           "rglru": (RG, "mixer", 0)}


def _quantized(layer_lora, cfg=JConfig(rho=0.9, bits_high=2, ste_steps=0)):
    """Every fp ``{'a', 'b'}`` leaf of one layer quantized by JAX: the
    reference's and the bridged port's leaves."""
    jq = {n: j_quantize_lora(leaf["b"], leaf["a"], cfg)
          for n, leaf in layer_lora.items()}
    return jq, {n: quantized_lora(q, "cpu") for n, q in jq.items()}


def _run(module, side, x, base, lora, cfg):
    mod = j_rec if side == "jax" else t_rec
    fn = {"tmix": mod.rwkv_tmix, "cmix": mod.rwkv_cmix,
          "rglru": mod.rglru_block}[module]
    return fn(x, base, lora, cfg)[0]


def _reference_launches(fn):
    """The reference's kernel launches of ``fn()``, traced once without
    jit."""
    jk.reset_launch_counts()
    with jax.disable_jit():
        jax.make_jaxpr(fn)()
    return dict(jk.LAUNCH_COUNTS)


@pytest.mark.parametrize("module", sorted(MODULES))
@pytest.mark.parametrize("form", ["quantized", "packed"])
def test_lora_forms_match_reference(rwkv, rg, module, form):
    """Each module with its LoRA leaves as one ``QuantizedLoRA`` adapter
    (``fused_lora``) or as a two-adapter ``PackedLoRABatch`` stack with
    per-row seg ids (``sgmv_fused``; row b meets adapter 1 - b): outputs
    against the reference and the port's plain kernel calls against its
    launches, one per LoRA linear."""
    arch, part, sub = MODULES[module]
    models = rwkv if arch == RWKV else rg
    x = _x((2, 16, 128), 21)
    if form == "quantized":
        jb, jl, tb, _ = models.layer(part, sub)
        jl, tl = _quantized(jl)
        kernel = "fused_lora"
    else:
        jstore = JStore(JConfig(rho=0.9, ste_steps=0))
        jstore.register_many({f"u{i}": j_random_lora(
            models.template, jax.random.PRNGKey(30 + i), scale=0.05)
            for i in range(2)})
        tstore = bridge_store(jstore)
        seg = np.repeat(np.asarray([1, 0], np.int32), 16)
        jpk = jstore.pack_batch(["u0", "u1"], models.jparams["lora"])
        tpk = tstore.pack_batch(["u0", "u1"], models.tparams["lora"])
        jtree = {"groups": [models.jmodel._attach_seg(
            g, jnp.asarray(seg), b.count)
            for g, b in zip(jpk["groups"], models.jcfg.blocks)]}
        ttree = {"groups": [models.tmodel._attach_seg(
            g, torch.from_numpy(seg)) for g in tpk["groups"]]}
        jb, jl, tb, tl = models.layer(part, sub, (jtree, ttree))
        kernel = "sgmv_fused"
    want = _run(module, "jax", jnp.asarray(x), jb, jl, models.jcfg)
    jcounts = _reference_launches(
        lambda: _run(module, "jax", jnp.asarray(x), jb, jl, models.jcfg))
    reset_launch_counts()
    got = _run(module, "torch", torch.from_numpy(x), tb, tl, models.tcfg)
    _close(got, want)
    assert dict(PLAIN_CALLS) == jcounts == {kernel: len(tl)}
    assert not LAUNCH_COUNTS
    plain = _run(module, "torch", torch.from_numpy(x), tb, None, models.tcfg)
    assert (plain - got).abs().max() > 100 * RTOL * got.abs().max()


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}/{i}"))
        return out
    return {path: tree}


CONSTANTS = ("mu_base", "mu", "decay_base", "bonus", "gn_w", "gn_b", "mu_k",
             "mu_r", "conv_b", "lambda_p")


@pytest.mark.parametrize("arch", [RWKV, RG])
def test_init_trees_match_reference(arch):
    """``Model.init`` of the port against JAX's at the smoke config in its
    own bf16: the same paths, shapes and dtypes for base and LoRA, the
    init's constant leaves (mixes, decay base, bonus, norms, biases, the
    RG-LRU's ``lambda_p``) bit for bit, LoRA B zero, the random leaves'
    scales alike."""
    from repro.configs import get_config as j_get_config

    jparams = j_build_model(j_get_config(arch, "smoke")).init(
        jax.random.PRNGKey(0))
    tparams = build_model(get_config(arch, "smoke")).init(seed=0,
                                                          device="cpu")
    jl, tl = _leaves(jparams), _leaves(tparams)
    assert sorted(jl) == sorted(tl)
    for path, j in jl.items():
        t = tl[path]
        assert tuple(t.shape) == j.shape, path
        assert t.dtype == to_torch(np.zeros((), j.dtype), "cpu").dtype, path
        name = path.rsplit("/", 1)[-1]
        js = float(jnp.std(j.astype(jnp.float32)))
        if name in CONSTANTS or js == 0:        # norms' weights too
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32))
        elif name == "b":
            assert not t.any()
        else:
            ts = float(t.float().std())
            assert 0.8 < ts / js < 1.25, (path, ts, js)


def test_bridge_carries_recurrent_trees():
    """``to_torch`` carries the recurrent trees as they are, dtypes and
    bits: RWKV-6's raw ``ddlerp_w2`` ``(L, 5, 32, d)`` and fp32 mixing
    leaves beside its bf16 projections, the RG-LRU's fp32 ``w_ix`` /
    ``w_ax`` / ``conv_w``, and the reference's caches (bf16 ``x_prev`` and
    ``conv``, fp32 ``s`` and ``h``)."""
    from repro.configs import get_config as j_get_config

    for arch, names in ((RWKV, ("ddlerp_w2", "ddlerp_w1", "decay_w2",
                                "mu", "wr")),
                        (RG, ("w_ix", "w_ax", "conv_w", "lambda_p",
                              "w_in"))):
        jmodel = j_build_model(j_get_config(arch, "smoke"))
        jparams = jmodel.init(jax.random.PRNGKey(1))
        jmixer = jparams["base"]["groups"][0]["sub_0"]["mixer"]
        tmixer = to_torch(jmixer, "cpu")
        for n in names:
            j = jmixer[n]["w"] if isinstance(jmixer[n], dict) else jmixer[n]
            t = tmixer[n]["w"] if isinstance(tmixer[n], dict) else tmixer[n]
            assert tuple(t.shape) == j.shape, n
            if j.dtype == jnp.bfloat16:
                assert t.dtype == torch.bfloat16, n
                got = t.view(torch.int16).numpy().view(np.uint16)
                np.testing.assert_array_equal(got,
                                              np.asarray(j).view(np.uint16))
            else:
                assert t.dtype == torch.float32, n
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        if arch == RWKV:
            assert tuple(tmixer["ddlerp_w2"].shape) == (2, 5, 32, 128)
        jcache = jmodel.init_cache(2, 8)
        tcache = to_torch(jcache, "cpu")
        leaf = (tcache[0]["sub_0"]["tmix"] if arch == RWKV
                else tcache[0]["sub_0"])
        want = ({"x_prev": torch.bfloat16, "s": torch.float32}
                if arch == RWKV else
                {"h": torch.float32, "conv": torch.bfloat16})
        assert {k: v.dtype for k, v in leaf.items()} == want
