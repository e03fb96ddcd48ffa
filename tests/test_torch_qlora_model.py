"""Port vs reference: the dense GQA decoder serving ONE LoRAQuant adapter
straight from packed codes — every LoRA leaf a layer-stacked
``QuantizedLoRA``, applied by ``fused_lora`` — at the smoke size of
llama3.2-3b (2 layers, d_model 128), fp32 on the CPU. JAX quantizes the
adapter and initializes the base; the bridge carries both across.
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
from repro.models import build_model as j_build_model
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.core import QuantizedLoRA
from repro_torch.kernels.quant_matmul import (
    LAUNCH_COUNTS,
    PLAIN_CALLS,
    reset_launch_counts,
)
from repro_torch.models import build_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# fp32 logits of a 2-layer model: the two frameworks round matmuls, rsqrt,
# cos/sin, softmax and the LoRA sums differently in the last bits; relative
# to max |logit| (the fp-adapter parity test holds 2e-5).
LOGIT_RTOL = 2e-5
LINEARS_PER_LAYER = 7


def _stacked_qlora(leaf, rng):
    """One layer-stacked JAX ``QuantizedLoRA`` for an ``{'a', 'b'}`` leaf
    ``a (L, r, K)``, ``b (L, M, r)``: per layer an adapter with the same
    decaying singular spectrum (so ``select_h`` gives every layer one h),
    quantized ``2@0.9`` without refinement, then stacked array by array."""
    n_layers, r, k = leaf["a"].shape
    m = leaf["b"].shape[1]
    s = np.exp(-0.4 * np.arange(r))
    qls = []
    for _ in range(n_layers):
        u = np.linalg.qr(rng.normal(size=(m, r)))[0]
        v = np.linalg.qr(rng.normal(size=(k, r)))[0]
        b = jnp.asarray((u * np.sqrt(s)).astype(np.float32))
        a = jnp.asarray((np.sqrt(s)[:, None] * v.T).astype(np.float32))
        qls.append(j_quantize_lora(b, a, JConfig(rho=0.9, bits_high=2,
                                                  ste_steps=0)))
    assert len({q.h for q in qls}) == 1 and qls[0].a_low is not None
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *qls)


def test_quantized_lora_tree_prefill_and_decode_match_reference():
    jcfg = smoke_cfg("llama3.2-3b")
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)

    def qtree(node):
        if isinstance(node, dict) and set(node) == {"a", "b"}:
            return _stacked_qlora(node, rng)
        if isinstance(node, dict):
            return {k: qtree(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(qtree(v) for v in node)
        return node

    jparams = {"base": jparams["base"], "lora": qtree(jparams["lora"])}
    tparams = to_torch(jparams, "cpu")
    wq = tparams["lora"]["groups"][0]["sub_0"]["mixer"]["wq"]
    assert isinstance(wq, QuantizedLoRA)
    assert wq.a_high.codes.shape[0] == jcfg.n_layers      # stacked (L, ...)
    tmodel = build_model(dataclasses.replace(
        get_config("llama3.2-3b", "smoke"), dtype=torch.float32))

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(want).max())

    toks = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    jk.reset_launch_counts()
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    assert dict(jk.LAUNCH_COUNTS) == {"fused_lora": LINEARS_PER_LAYER}
    reset_launch_counts()
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 16)
    close(tl, jl)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for step in range(3):
        pos = np.full((2,), 8 + step, np.int32)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt), jc,
                                    jnp.asarray(pos))
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(nxt), tc,
                                    torch.from_numpy(pos))
        close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    # every LoRA linear of every layer of all 4 forwards reached fused_lora
    forwards = 4
    assert dict(PLAIN_CALLS) == {
        "fused_lora": jcfg.n_layers * LINEARS_PER_LAYER * forwards}
    assert not LAUNCH_COUNTS
