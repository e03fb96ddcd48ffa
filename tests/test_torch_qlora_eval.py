"""Port vs reference: the eval of a trained adapter straight from its
packed codes (ROADMAP A7, the card's phase 30) at smoke size, fp32 on the
CPU: ``Model.train_loss`` with every LoRA leaf a layer-stacked
``QuantizedLoRA`` against the reference's ``train_loss`` on the same leaves
(its Pallas ``fused_lora`` in interpret mode), with launch-count parity,
and ``chip_smoke``'s regrouping and materialized leaves.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import smoke_cfg
from repro.configs.base import BlockSpec as JBlockSpec
from repro.core import LoRAQuantConfig as JConfig
from repro.core import quantize_lora as j_quantize_lora
from repro.data import pipeline as jdata
from repro.kernels.quant_matmul import kernel as jk
from repro.models import build_model as j_build_model
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS, PLAIN_CALLS,
                                               reset_launch_counts)
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
LINEARS = 7


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _j_per_layer(jcfg, params):
    """The reference's model with every layer its own group of one."""
    blocks = tuple(JBlockSpec(count=1, pattern=b.pattern, ffn=b.ffn)
                   for b in jcfg.blocks for _ in range(b.count))
    cfg = dataclasses.replace(jcfg, blocks=blocks)

    def regroup(groups):
        return [jax.tree_util.tree_map(lambda x: x[i:i + 1], g)
                for g, blk in zip(groups, jcfg.blocks)
                for i in range(blk.count)]

    return cfg, {"base": dict(params["base"],
                              groups=regroup(params["base"]["groups"])),
                 "lora": {"groups": regroup(params["lora"]["groups"])}}


def test_eval_from_stacked_quantized_leaves_matches_reference():
    """``train_loss`` with every LoRA leaf a layer-stacked ``QuantizedLoRA``
    (each layer its own group, so each stack has one split h, as the
    card's phase 30 builds it; ``2@0.9``), against the reference's
    ``train_loss`` on the same leaves through its Pallas ``fused_lora`` in
    interpret mode: CE within fp32 tolerance, one launch per LoRA linear per
    layer on both sides, and ``chip_smoke``'s regrouping and materialized
    leaves giving the same CE."""
    cs = _chip_smoke()
    jcfg = dataclasses.replace(smoke_cfg("llama3.2-3b"), vocab=256)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)

    def trained(node):
        if isinstance(node, dict) and set(node) == {"a", "b"}:
            return {"a": node["a"], "b": jnp.asarray(
                rng.normal(size=node["b"].shape).astype(np.float32) * 0.05)}
        if isinstance(node, dict):
            return {k: trained(v) for k, v in node.items()}
        if isinstance(node, list):
            return [trained(v) for v in node]
        return node

    jparams = {"base": jparams["base"], "lora": trained(jparams["lora"])}
    pcfg, pparams = _j_per_layer(jcfg, jparams)
    qcfg = JConfig(rho=0.9, bits_high=2, refine="none")

    def quant(node):
        if isinstance(node, dict) and set(node) == {"a", "b"}:
            q = j_quantize_lora(node["b"][0], node["a"][0], qcfg)
            return jax.tree_util.tree_map(lambda x: x[None], q)
        if isinstance(node, dict):
            return {k: quant(v) for k, v in node.items()}
        if isinstance(node, list):
            return [quant(v) for v in node]
        return node

    qparams = {"base": pparams["base"], "lora": quant(pparams["lora"])}
    batch = jdata.make_batch(jdata.DataConfig(seq_len=16, global_batch=2,
                                              vocab=256, seed=101), 10_000)
    jk.reset_launch_counts()
    jloss, jm = j_build_model(pcfg).train_loss(
        qparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert dict(jk.LAUNCH_COUNTS) == {"fused_lora": jcfg.n_layers * LINEARS}

    tcfg = dataclasses.replace(get_config("llama3.2-3b", "smoke"),
                               dtype=torch.float32, vocab=256)
    ptcfg, tparams = cs.per_layer_groups(tcfg, to_torch(jparams, "cpu"))
    assert ptcfg.blocks == tuple(
        dataclasses.replace(b, count=1) for b in tcfg.blocks
        for _ in range(b.count))
    tq = {"base": tparams["base"], "lora": to_torch(qparams["lora"], "cpu")}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    reset_launch_counts()
    with torch.no_grad():
        tloss, tm = build_model(ptcfg).train_loss(tq, tb)
    assert dict(PLAIN_CALLS) == {"fused_lora": jcfg.n_layers * LINEARS}
    assert not LAUNCH_COUNTS
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    # the benchmark's route: the same codes materialized as fp leaves
    mat = {"base": tparams["base"],
           "lora": cs.materialized_tree(tq["lora"])}
    with torch.no_grad():
        mloss, mm = build_model(ptcfg).train_loss(mat, tb)
    np.testing.assert_allclose(float(mm["ce"]), float(jm["ce"]), rtol=1e-5)
