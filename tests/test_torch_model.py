"""Port vs reference: the dense GQA decoder (``repro_torch.models`` against
``repro.models``) at the smoke size of llama3.2-3b (2 layers, d_model 128),
fp32 on the CPU, parameters initialized by JAX and carried across by the
bridge.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.launch.serve import random_trained_lora
from repro.models import build_model as j_build_model
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.quant_matmul import PLAIN_CALLS, reset_launch_counts
from repro_torch.models import build_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# fp32 logits of a 2-layer model: the two frameworks round matmuls, rsqrt,
# cos/sin and softmax differently in the last bits; relative to max |logit|.
LOGIT_RTOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jcfg = smoke_cfg("llama3.2-3b")
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    # a trained-looking adapter so the LoRA path matters
    jparams = {"base": jparams["base"],
               "lora": random_trained_lora(jparams["lora"],
                                           jax.random.PRNGKey(3), scale=0.05)}
    tcfg = dataclasses.replace(get_config("llama3.2-3b", "smoke"),
                               dtype=torch.float32)
    return jcfg, jmodel, jparams, build_model(tcfg), to_torch(jparams, "cpu")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


PORTED = ("llama3.2-3b", "internlm2-20b", "gemma2-2b", "olmo-1b",
          "rwkv6-1.6b", "mixtral-8x22b", "deepseek-v3-671b",
          "recurrentgemma-2b", "musicgen-medium", "qwen2-vl-72b")
CONFIG_FIELDS = (
    "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
    "vocab", "head_dim", "resolved_head_dim", "norm", "post_norm", "rope",
    "rope_theta", "mrope_sections", "window", "attn_softcap",
    "logit_softcap", "tie_embeddings", "n_codebooks", "vision_stub",
    "subquadratic", "lora_rank", "lora_alpha", "mtp", "base_quant_bits",
    "rwkv_head_dim", "rglru_width", "conv_width")


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_config_matches_reference(arch, preset):
    """Every ported arch, field for field (the nested MoE and MLA configs
    included) and block for block."""
    from repro.configs import get_config as j_get_config

    j, t = j_get_config(arch, preset), get_config(arch, preset)
    for f in CONFIG_FIELDS:
        assert getattr(t, f) == getattr(j, f), (arch, preset, f)
    for f in ("moe", "mla"):
        tj, tt = getattr(j, f), getattr(t, f)
        assert (tt is None) == (tj is None), (arch, preset, f)
        if tj is not None:
            assert dataclasses.asdict(tt) == dataclasses.asdict(tj)
    assert [dataclasses.astuple(b) for b in t.blocks] == \
        [dataclasses.astuple(b) for b in j.blocks]
    assert t.total_layers() == j.total_layers()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_recurrent_configs_load_and_match_reference(arch):
    """The recurrent configs load at both presets and equal the
    reference's field for field (the RWKV head, RG-LRU width and conv
    width included), block for block; every architecture of the JAX
    package is one the port's registry knows."""
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ARCH_IDS as J_ARCH_IDS
    from repro_torch.configs import ARCH_IDS

    assert ARCH_IDS == J_ARCH_IDS
    for preset in ("full", "smoke"):
        j, t = j_get_config(arch, preset), get_config(arch, preset)
        assert {f: getattr(t, f) for f in CONFIG_FIELDS} == \
            {f: getattr(j, f) for f in CONFIG_FIELDS}, preset
        assert [dataclasses.astuple(b) for b in t.blocks] == \
            [dataclasses.astuple(b) for b in j.blocks]
        assert t.subquadratic and t.total_layers() == t.n_layers


def test_prefill_and_decode_logits_match_reference(models):
    jcfg, jmodel, jparams, tmodel, tparams = models
    g = np.random.default_rng(0)
    toks = g.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    start = np.asarray([0, 3], np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                      "start": jnp.asarray(start)}, 32)
    reset_launch_counts()
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                      "start": torch.from_numpy(start)}, 32)
    _close(tl, jl)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for step in range(3):
        pos = np.full((2,), 12 + step, np.int32)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt), jc,
                                    jnp.asarray(pos), jnp.asarray(start))
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(nxt), tc,
                                    torch.from_numpy(pos),
                                    torch.from_numpy(start))
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    # caches agree too (the port writes them in place)
    _close(tc[0]["sub_0"]["k"], jc[0]["sub_0"]["k"])
    assert not PLAIN_CALLS          # fp LoRA trees never reach the kernel


def test_left_padded_batch_equals_unpadded(models):
    """A left-padded row (masked pads, real positions) gives the logits and
    decode steps of the same prompt served alone."""
    _, _, _, tmodel, tparams = models
    g = np.random.default_rng(1)
    prompt = torch.from_numpy(g.integers(0, 512, (1, 7)))
    padded = torch.cat([torch.zeros((1, 5), dtype=torch.int64), prompt], 1)
    solo_l, solo_c = tmodel.prefill(tparams, {"tokens": prompt}, 32)
    pad_l, pad_c = tmodel.prefill(tparams, {
        "tokens": padded, "start": torch.tensor([5])}, 32)
    torch.testing.assert_close(pad_l[:, 5:], solo_l, rtol=1e-5, atol=1e-5)
    tok = solo_l[:, -1].argmax(-1)[:, None]
    for step in range(3):
        solo_l, solo_c = tmodel.decode_step(tparams, tok, solo_c,
                                            torch.tensor([7 + step]))
        pad_l, pad_c = tmodel.decode_step(tparams, tok, pad_c,
                                          torch.tensor([12 + step]),
                                          torch.tensor([5]))
        torch.testing.assert_close(pad_l, solo_l, rtol=1e-5, atol=1e-5)
        tok = solo_l[:, -1].argmax(-1)[:, None]


def test_linear_branches():
    from repro_torch.core import QuantizedLoRA
    from repro_torch.models.common import linear

    x = torch.randn(3, 8, dtype=torch.bfloat16)
    base = {"w": torch.randn(8, 4, dtype=torch.bfloat16)}
    lora = {"a": torch.randn(2, 8), "b": torch.randn(4, 2)}
    y = linear(x, base, lora, scaling=2.0)
    assert y.dtype == torch.bfloat16
    want = x @ base["w"] + (2.0 * ((x.float() @ lora["a"].T) @ lora["b"].T)
                            ).to(torch.bfloat16)
    torch.testing.assert_close(y, want)
    # one adapter straight from packed codes: one fused_lora per call, the
    # update cast to the base dtype
    from repro_torch.core import LoRAQuantConfig, quantize_lora
    from repro_torch.kernels import lora_apply_quantized

    q = quantize_lora(torch.randn(4, 2), torch.randn(2, 8),
                      LoRAQuantConfig(rho=0.9, refine="none"))
    assert isinstance(q, QuantizedLoRA)
    x3 = x.reshape(1, 3, 8)
    reset_launch_counts()
    y = linear(x3, base, q, scaling=2.0)
    assert dict(PLAIN_CALLS) == {"fused_lora": 1}
    assert y.shape == (1, 3, 4) and y.dtype == torch.bfloat16
    want = x @ base["w"] + lora_apply_quantized(x, q, scaling=2.0)
    torch.testing.assert_close(y[0], want)
    # a mixed-recipe PackedLoRABuckets leaf: one sgmv_fused per bucket, the
    # same update as the reference's linear
    from repro.core import LoRAQuantConfig as JConfig
    from repro.core import quantize_lora as j_quantize_lora
    from repro.kernels import PackedLoRABuckets as JBuckets
    from repro.kernels import pack_adapter_layers as j_pack
    from repro.kernels import stack_packed_adapters as j_stack
    from repro.models.common import linear as j_linear
    from repro_torch.bridge import quantized_lora
    from repro_torch.kernels import (PackedLoRABuckets, pack_adapter_layers,
                                     stack_packed_adapters)

    g = np.random.default_rng(11)
    jq = [j_quantize_lora(jnp.asarray(g.normal(size=(4, 2)), jnp.float32),
                          jnp.asarray(g.normal(size=(2, 8)), jnp.float32),
                          JConfig(rho=0.9, bits_high=bits, ste_steps=0))
          for bits in (2, 4, 2)]
    members = [[0, 2], [1]]                  # signatures (2,·,1), (4,·,1)
    luts = [np.asarray([0, -1, 1], np.int32), np.asarray([-1, 0, -1],
                                                         np.int32)]
    seg = np.asarray([2, 0, 1], np.int32)
    xf = g.normal(size=(3, 8)).astype(np.float32)
    wf = g.normal(size=(8, 4)).astype(np.float32)
    jb = JBuckets(
        buckets=tuple(jax.tree_util.tree_map(
            lambda z: z[0], j_stack([j_pack([jq[i]]) for i in idx],
                                    tile_t=1)) for idx in members),
        lookups=tuple(jnp.asarray(lut) for lut in luts),
        seg=jnp.asarray(seg))
    want = np.asarray(j_linear(jnp.asarray(xf), {"w": jnp.asarray(wf)}, jb,
                               scaling=2.0))
    tb = PackedLoRABuckets(
        buckets=tuple(stack_packed_adapters(
            [pack_adapter_layers([quantized_lora(jq[i], "cpu")])
             for i in idx], tile_t=1).layer(0) for idx in members),
        lookups=tuple(torch.from_numpy(lut) for lut in luts),
        seg=torch.from_numpy(seg))
    reset_launch_counts()
    got = linear(torch.from_numpy(xf), {"w": torch.from_numpy(wf)}, tb,
                 scaling=2.0)
    assert dict(PLAIN_CALLS) == {"sgmv_fused": 2}
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(TypeError, match="unsupported LoRA leaf"):
        linear(x, base, object())


def test_cuda_entry_point_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    model = build_model(get_config("llama3.2-3b", "smoke"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(seed=0)
