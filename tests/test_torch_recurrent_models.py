"""Port vs reference: rwkv6-1.6b and recurrentgemma-2b as models
(``repro_torch.models`` against ``repro.models``) at the smoke sizes
(rwkv6: 2 layers of d_model 128; recurrentgemma: one (rglru, rglru,
local_attn) period, and a two-group variant with the (rglru, rglru) tail
group the full config has), fp32 on the CPU, and a CPU rehearsal of
``chip_smoke.py``'s phases 36-40.

Parameters are initialized by JAX (the init's constant leaves perturbed)
and carried across by the bridge. Held: logits and losses within
``RTOL`` x max |y|, LoRA gradients within ``GRAD_RTOL`` of each leaf's
max |grad|, caches and states to fp32 tolerance. Pad tokens flow through
the recurrent states in both packages, so a left-padded row's logits are
the reference's, not an unpadded run's. ``RecModels`` is shared with
``test_torch_recurrent_serving.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.configs.base import BlockSpec as JBlockSpec
from repro.launch.serve import random_trained_lora as j_random_lora
from repro.models import build_model as j_build_model
from repro_torch.bridge import to_torch
from repro_torch.configs import BlockSpec, get_config
from repro_torch.models import build_model
from repro_torch.optim import adamw as topt
from test_torch_faults import ROOT, load
from test_torch_memory import Models
from test_torch_recurrent import _perturb
from test_torch_train_step import _nonzero_b, close_leaves

RWKV, RG = "rwkv6-1.6b", "recurrentgemma-2b"
RG2 = "recurrentgemma-2b/two-groups"
# LoRA linears per forward at the smoke sizes: rwkv6 2 x (5 + 3);
# recurrentgemma (3 + 3) + (3 + 3) + (4 + 3), and 12 more in the tail group
PER_FORWARD = {RWKV: 16, RG: 19, RG2: 31}
RTOL = 2e-5
GRAD_RTOL = 1e-5


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


def _configs(name):
    """The reference's smoke config (fp32) and the port's; ``RG2`` adds
    the full config's (rglru, rglru) tail group to both."""
    arch = name.split("/")[0]
    jcfg = smoke_cfg(arch)
    tcfg = dataclasses.replace(get_config(arch, "smoke"),
                               dtype=torch.float32)
    if name == RG2:
        tail = (("rglru", "rglru"), ("dense", "dense"))
        jcfg = dataclasses.replace(jcfg, n_layers=5, blocks=jcfg.blocks + (
            JBlockSpec(count=1, pattern=tail[0], ffn=tail[1]),))
        tcfg = dataclasses.replace(tcfg, n_layers=5, blocks=tcfg.blocks + (
            BlockSpec(count=1, pattern=tail[0], ffn=tail[1]),))
    return jcfg, tcfg


class RecModels(Models):
    """:class:`Models` over a recurrent smoke config, the init's constant
    leaves perturbed (RWKV's bonus, mixes and norm bias, the conv bias)."""

    def __init__(self, name):
        self.name = name
        self.jcfg, tcfg = _configs(name)
        self.jmodel = j_build_model(self.jcfg)
        raw = self.jmodel.init(jax.random.PRNGKey(0))
        self.jparams = {"base": _perturb(raw["base"],
                                         np.random.default_rng(7)),
                        "lora": raw["lora"]}
        self.tmodel = build_model(tcfg)
        self.tparams = to_torch(self.jparams, "cpu")
        self._jits = {}

    def trained(self, seed):
        return j_random_lora(self.jparams["lora"], jax.random.PRNGKey(seed),
                             scale=0.05)


_MODELS = {}


def models_of(name) -> RecModels:
    if name not in _MODELS:
        _MODELS[name] = RecModels(name)
    return _MODELS[name]


# --------------------------------------------------------------------------
# the model: forward, train_loss and its LoRA gradients, prefill / decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", [RWKV, RG, RG2])
def test_forward_logits_match_reference(name):
    """``Model.forward`` of 24 tokens with a trained fp adapter: logits
    (rwkv6 through three chunks of its ``rwkv_chunk`` 8 on both sides)."""
    m = models_of(name)
    params = {"base": m.jparams["base"], "lora": m.trained(3)}
    toks = np.random.default_rng(1).integers(
        0, m.jcfg.vocab, (2, 24)).astype(np.int32)
    kw = {"rwkv_chunk": 8} if name == RWKV else {}
    want, _ = j_build_model(m.jcfg, **kw).forward(
        params, {"tokens": jnp.asarray(toks)})
    got, aux = build_model(m.tmodel.cfg, **kw).forward(
        to_torch(params, "cpu"), {"tokens": torch.from_numpy(toks).long()})
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("name", [RWKV, RG, RG2])
def test_train_loss_and_lora_grads_match_reference(name):
    """``train_loss`` and the gradient of every LoRA leaf against
    ``jax.grad``; with ``remat`` (each layer recomputed on the backward)
    the port's loss and gradients are bit-identical."""
    m = models_of(name)
    params = {"base": m.jparams["base"],
              "lora": _nonzero_b(m.jparams["lora"], jax.random.PRNGKey(1))}
    toks = np.random.default_rng(4).integers(
        0, m.jcfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][:, 3] = -1

    def f(lora):
        return m.jmodel.train_loss(
            {"base": params["base"], "lora": lora},
            {k: jnp.asarray(v) for k, v in batch.items()})

    (jloss, jm), jgrad = jax.value_and_grad(f, has_aux=True)(params["lora"])
    results = []
    for remat in (False, True):
        tparams = to_torch(params, "cpu")
        leaves = topt.tree_leaves(tparams["lora"])
        for leaf in leaves:
            leaf.requires_grad_(True)
        tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        loss, metrics = build_model(m.tmodel.cfg, remat=remat).train_loss(
            tparams, tbatch)
        grads = torch.autograd.grad(loss, leaves)
        results.append((loss, grads))
    loss, grads = results[0]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    close_leaves([g.numpy() for g in grads], jgrad, GRAD_RTOL,
                 f"{name} d/dlora")
    assert all(float(np.abs(g.numpy()).max()) > 0 for g in grads)
    rloss, rgrads = results[1]
    assert torch.equal(rloss, loss)
    assert all(torch.equal(a, b) for a, b in zip(rgrads, grads))


def _states(caches):
    """Every recurrent state leaf of a cache list, by path."""
    out = {}
    for gi, group in enumerate(caches):
        for sub, tree in group.items():
            stack = [(f"{gi}/{sub}", tree)]
            while stack:
                path, node = stack.pop()
                for k, v in node.items():
                    if isinstance(v, dict):
                        stack.append((f"{path}/{k}", v))
                    else:
                        out[f"{path}/{k}"] = v
    return out


@pytest.mark.parametrize("name", [RWKV, RG, RG2])
def test_prefill_and_decode_match_reference(name):
    """A left-padded prefill (row 1 padded by 3) and three decode steps
    with a trained fp adapter: logits, greedy tokens and every cache leaf
    (the states, the local attention's ring). Pad tokens flow through the
    recurrent states in both packages: row 1's logits are not those of its
    prompt served alone (at its first real token, whose token shift or
    conv window reads pads)."""
    m = models_of(name)
    jp = {"base": m.jparams["base"], "lora": m.trained(3)}
    tp = to_torch(jp, "cpu")
    g = np.random.default_rng(0)
    toks = g.integers(0, m.jcfg.vocab, (2, 16)).astype(np.int32)
    start = np.asarray([0, 3], np.int32)
    jl, jc = m.jmodel.prefill(jp, {"tokens": jnp.asarray(toks),
                                   "start": jnp.asarray(start)}, 32)
    tl, tc = m.tmodel.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                                   "start": torch.from_numpy(start).long()},
                              32)
    _close(tl, jl)
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy()[:, None],
                                      nxt)
        pos = np.full((2,), 16 + step, np.int32)
        jl, jc = m.jmodel.decode_step(jp, jnp.asarray(nxt), jc,
                                      jnp.asarray(pos), jnp.asarray(start))
        tl, tc = m.tmodel.decode_step(tp, torch.from_numpy(nxt).long(), tc,
                                      torch.from_numpy(pos).long(),
                                      torch.from_numpy(start).long())
        _close(tl, jl)
    jst, tst = _states(jc), _states(tc)
    assert sorted(jst) == sorted(tst)
    for path, want in jst.items():
        assert tst[path].dtype == to_torch(np.zeros((), want.dtype),
                                           "cpu").dtype, path
        _close(tst[path], want)
    solo, _ = m.tmodel.prefill(tp, {"tokens": torch.from_numpy(
        toks[1:, 3:]).long()}, 32)
    padded, _ = m.tmodel.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                                      "start": torch.from_numpy(
                                          start).long()}, 32)
    # the first real token: its conv window / token shift holds pads
    gap = (solo[0, 0] - padded[1, 3]).abs().max()
    assert gap > 100 * RTOL * solo.abs().max()


def test_cache_trees_match_reference():
    """``init_cache``'s tree for both kinds of recurrent sub-block:
    rwkv's ``{"tmix": {"x_prev", "s"}, "cmix": {"x_prev"}}`` and the
    RG-LRU's ``{"h", "conv"}`` beside local attention's ring, with the
    reference's shapes and dtypes (the smoke configs in their own bf16)."""
    from repro.configs import get_config as j_get_config

    for arch in (RWKV, RG):
        jc = j_build_model(j_get_config(arch, "smoke")).init_cache(3, 16)
        tc = build_model(get_config(arch, "smoke")).init_cache(3, 16,
                                                               device="cpu")
        jst, tst = _states(jc), _states(tc)
        assert sorted(jst) == sorted(tst)
        for path, want in jst.items():
            assert tuple(tst[path].shape) == want.shape, path
            assert tst[path].dtype == to_torch(np.zeros((), want.dtype),
                                               "cpu").dtype, path
            assert not tst[path].float().any()
    assert set(tc[0]["sub_0"]) == {"h", "conv"}
    assert set(tc[0]["sub_2"]) == {"k", "v"}


def test_unknown_layer_kind_raises_in_both_packages():
    """A layer kind neither package knows: both inits raise ``ValueError``
    naming it (the mixer and the feed-forward), as does the port's
    cache."""
    base = get_config(RWKV, "smoke")
    jbase = smoke_cfg(RWKV)
    for pattern, ffn in ((("mamba",), ("rwkv_cm",)), (("rwkv",), ("glu",))):
        bad = pattern[0] if pattern[0] == "mamba" else ffn[0]
        jcfg = dataclasses.replace(jbase, blocks=(JBlockSpec(
            count=1, pattern=pattern, ffn=ffn),))
        tcfg = dataclasses.replace(base, blocks=(BlockSpec(
            count=1, pattern=pattern, ffn=ffn),))
        with pytest.raises(ValueError, match=bad):
            j_build_model(jcfg).init(jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match=bad):
            build_model(tcfg).init(device="cpu")
    with pytest.raises(ValueError, match="mamba"):
        build_model(dataclasses.replace(base, blocks=(BlockSpec(
            count=1, pattern=("mamba",), ffn=("dense",)),))).init_cache(
                1, 8, device="cpu")


def test_chip_smoke_recurrent_phases_rehearse_on_the_cpu():
    """``chip_smoke.py``'s phases 36-40 on the CPU at the smoke size (the
    plain versions in place of the kernels; phase 36 by its shapes): the
    seven (K, M) of the full configs and their 192 and 164 launches per
    forward, the shapes of the smoke templates' LoRA linears, the mixers'
    prefill + decode against their sequence forwards, both continuous
    serves with the reference's paging, and the fp32 parity of both at
    the cut depths, recurrentgemma's through both of its groups."""
    from repro_torch.serving.engine import iter_lora_linears

    chip_smoke = load("chip_smoke", ROOT / "chip_smoke.py")
    full = {a: chip_smoke.rec_config(a, torch.bfloat16)
            for a in chip_smoke.REC_ARCHS}
    assert {a: len(chip_smoke.rec_linears(c)) for a, c in full.items()} == {
        RWKV: 192, RG: 164}
    assert sorted({km for c in full.values()
                   for km in chip_smoke.rec_linears(c).values()}) == sorted([
                       (2048, 2048), (2048, 7168), (7168, 2048),
                       (2560, 2560), (2560, 256), (2560, 7680),
                       (7680, 2560)])
    for name, counts in ((RWKV, None), (RG2, (1, 1))):
        cfg = chip_smoke.rec_config(name.split("/")[0], torch.float32,
                                    counts, "smoke")
        lora = build_model(cfg).init(seed=0, device="cpu")["lora"]
        want = sorted((leaf["a"].shape[-1], leaf["b"].shape[-2])
                      for _, leaf in iter_lora_linears(lora)
                      for _ in range(leaf["a"].shape[0]))
        assert sorted(chip_smoke.rec_linears(cfg).values()) == want
        assert len(want) == PER_FORWARD[name]
    parity = chip_smoke.REC_PARITY
    assert chip_smoke.rec_config(RG, torch.float32, parity[RG]).blocks == (
        dataclasses.replace(full[RG].blocks[0], count=1), full[RG].blocks[1])
    mixers = chip_smoke.phase_rec_mixers("cpu", "smoke")
    for arch in chip_smoke.REC_ARCHS:
        assert mixers[f"{arch}_decode_err"] <= mixers[f"{arch}_tol"]
    assert mixers["long_err"] <= mixers["long_tol"]
    for arch in chip_smoke.REC_ARCHS:
        serve = chip_smoke.phase_rec_serve(arch, "cpu", "smoke")
        assert serve["launches"] == PER_FORWARD[arch] * 24  # 3 + 21
        fp32 = chip_smoke.phase_rec_parity(arch, "cpu", "smoke")
        assert fp32["gap"] <= fp32["tol"]
