"""Port vs reference: gemma2-2b at its smoke size (one period of local /
global attention, window 8), fp32 on the CPU: ``(1+w)`` RMSNorm with
post-block norms, attention and logit soft-caps, GELU, the embedding scale
and the tied table; a local layer's ring of ``window`` cache slots beside a
global layer's full cache in one model; packed model-level prefill and
decode, the blockwise attention with its cap, and the continuous engine
against the reference's. Helpers: ``tests/test_torch_dense_variants.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as j_build_model
from repro_torch.bridge import to_torch
from repro_torch.models.model import Model
from test_torch_dense_variants import (DenseModels, close, continuous_parity,
                                       packed_model_parity)

ARCH = "gemma2-2b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    return DenseModels(ARCH)


def test_params_tree_is_the_reference_one(models):
    """The port's own init has the reference's tree: a tied table, zero
    ``(1+w)`` norms and the two post-block norms per sub-block."""
    mine = models.tmodel.init(seed=0, device="cpu")["base"]
    ref = models.tparams["base"]
    assert set(mine) == set(ref) == {"embed_tied", "final_norm", "groups"}
    for j in (0, 1):
        sub, rsub = mine["groups"][0][f"sub_{j}"], ref["groups"][0][f"sub_{j}"]
        assert set(sub) == set(rsub) == {
            "mixer", "mixer_norm", "ffn", "ffn_norm", "post_mixer_norm",
            "post_ffn_norm"}
        for n in ("mixer_norm", "post_mixer_norm", "ffn_norm",
                  "post_ffn_norm"):
            assert sub[n]["w"].shape == rsub[n]["w"].shape == (1, 128)
            assert not sub[n]["w"].any()


def test_packed_prefill_past_the_window_and_decode_match_reference(models):
    """Left-padded 16-token prompts (twice the window) and 4 decode steps:
    logits, tokens, launches; the local layer keeps a ring of 8 slots, the
    global layer all 32."""
    g = np.random.default_rng(0)
    batch = {"tokens": g.integers(0, 512, (2, 16)).astype(np.int32),
             "start": np.asarray([0, 5], np.int32)}
    packed_model_parity(models, batch, n_decode=4)
    caches = models.tmodel.init_cache(2, 32, device="cpu")[0]
    assert caches["sub_0"]["k"].shape[2] == 8          # local_attn ring
    assert caches["sub_1"]["k"].shape[2] == 32         # global attn


def test_soft_caps_bound_the_logits_and_move_them(models):
    """The logit cap bounds every logit by 30, and both caps change what
    an uncapped model computes (so the tests above would see them lost)."""
    jp = {"base": models.jparams["base"], "lora": models.trained(3)}
    tp = to_torch(jp, "cpu")
    # grow the weights so the caps bite at this size
    tp["base"]["embed_tied"]["e"] = tp["base"]["embed_tied"]["e"] * 60
    for sub in tp["base"]["groups"][0].values():
        for name in ("wq", "wk"):
            sub["mixer"][name]["w"] = sub["mixer"][name]["w"] * 8
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (1, 12)))
    capped, _ = models.tmodel.prefill(tp, {"tokens": toks}, 16)
    assert capped.abs().max() <= 30.0
    for field in ("attn_softcap", "logit_softcap"):
        free = Model(dataclasses.replace(models.tmodel.cfg, **{field: None}))
        other, _ = free.prefill(tp, {"tokens": toks}, 16)
        assert (other - capped).abs().max() > 1e-3, field


def test_blockwise_prefill_matches_reference(models):
    """The blockwise attention (forced) with the soft-cap and the window
    through the whole model, with a trained fp adapter."""
    jmodel = j_build_model(models.jcfg, force_blockwise=True, kv_chunk=1024)
    jp = {"base": models.jparams["base"], "lora": models.trained(4)}
    tp = to_torch(jp, "cpu")
    g = np.random.default_rng(6)
    toks = g.integers(0, 512, (2, 20)).astype(np.int32)
    start = np.asarray([3, 0], np.int32)
    jl, _ = jmodel.prefill(jp, {"tokens": jnp.asarray(toks),
                                "start": jnp.asarray(start)}, 32)
    tmodel = Model(models.tmodel.cfg, force_blockwise=True)
    tl, _ = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks),
                                "start": torch.from_numpy(start)}, 32)
    close(tl, jl)
    plain, _ = models.tmodel.prefill(tp, {"tokens": torch.from_numpy(toks),
                                          "start": torch.from_numpy(start)},
                                     32)
    close(tl[:, 3:], plain[:, 3:].numpy())


def test_continuous_engine_tokens_match_reference(models):
    """Prompts of 10 tokens (past the window of 8) served continuously on
    2 rows over 2 slots of 3 adapters: the reference's tokens step by
    step, its paging and its launches."""
    done = continuous_parity(models, ["u0", "u1", "u0", "u2", "u1"])
    assert len(done) == 5
