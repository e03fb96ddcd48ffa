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


def test_config_matches_reference():
    from repro.configs import get_config as j_get_config

    for preset in ("full", "smoke"):
        j, t = j_get_config("llama3.2-3b", preset), get_config(
            "llama3.2-3b", preset)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "resolved_head_dim", "rope_theta", "lora_rank",
                  "lora_alpha", "tie_embeddings"):
            assert getattr(t, f) == getattr(j, f), f
    with pytest.raises(NotImplementedError, match="A10"):
        get_config("mixtral-8x22b")


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
    fake = QuantizedLoRA(None, None, None, None, h=1, rank=2, config=None)
    with pytest.raises(NotImplementedError, match="B3"):
        linear(x, base, fake)


def test_cuda_entry_point_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    model = build_model(get_config("llama3.2-3b", "smoke"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(seed=0)
