"""ROADMAP C9: in bf16, does a request's output depend on which requests
share its prefill group — in the reference too, or only in the port?

Both packages' continuous engines serve ``chip_smoke``'s Zipf stream (the
stream of the card's phase 13: 16 requests over 8 adapters ``2@0.9``, 8
rows) at llama3.2-3b's smoke size with its full FFN width (d_ff 8192: at
the smoke width of 256 no bf16 sum depends on the row count in either
package), in bf16, all-resident and bounded to 4 slots. The two
schedules admit the requests in different prefill groups
(``ZIPF_BOUNDED`` says how). Each package's own first-token (prefill)
logits of every request are compared between its two schedules.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.core import LoRAQuantConfig as JConfig
from repro.launch.serve import random_trained_lora as j_random_lora
from repro.models import build_model as j_build_model
from repro.serving.engine import AdapterStore as JStore
from repro.serving.engine import MultiLoRAEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.bridge import quantized_adapter, to_torch
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import AdapterStore, MultiLoRAEngine, Request

ROOT = Path(__file__).resolve().parents[1]
CAPACITY = 64
# llama3.2-3b's FFN width: its down projection sums K = 8192 products
D_FF = 8192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorder(fn, rows_out, groups_out):
    """Wrap a prefill callable ``fn(params, batch, ...)``: record each
    row's fp32 last-position logits under its prompt (the row past its
    left pad), and each group's size."""
    def call(params, batch, *a, **kw):
        logits, caches = fn(params, batch, *a, **kw)
        toks = np.asarray(batch["tokens"]).astype(np.int32)
        starts = np.asarray(batch["start"])
        last = np.asarray(
            jnp.asarray(logits[:, -1]).astype(jnp.float32)
            if not isinstance(logits, torch.Tensor)
            else logits[:, -1].to(torch.float32))
        groups_out.append(len(toks))
        for t, st, l in zip(toks, starts, last):
            rows_out[t[int(st):].tobytes()] = l       # the prompt, unpadded
        return logits, caches
    return call


def _serve(package, ctx, ids, prompts, slots):
    """One schedule on one package: ``(outputs, prefill logits per
    request, group sizes)``."""
    cs = ctx["cs"]
    rows, groups = {}, []
    if package == "jax":
        eng = JEngine(ctx["jmodel"], ctx["jparams"], ctx["jstore"],
                      cache_capacity=CAPACITY, max_rows=cs.CONT_ROWS,
                      hbm_slots=slots)
        eng._prefill = _recorder(eng._prefill, rows, groups)
        cls = JRequest
    else:
        eng = MultiLoRAEngine(ctx["tmodel"], ctx["tparams"], ctx["tstore"],
                              cache_capacity=CAPACITY,
                              max_rows=cs.CONT_ROWS, hbm_slots=slots)
        ctx["tmodel"].prefill = _recorder(
            type(ctx["tmodel"]).prefill.__get__(ctx["tmodel"]), rows, groups)
        cls = Request
    try:
        for i, (aid, p) in enumerate(zip(ids, prompts)):
            eng.submit(cls(request_id=i, adapter_id=aid,
                           prompt=p.copy(), max_new_tokens=cs.MAX_NEW))
        done = {r.request_id: np.asarray(r.output) for r in eng.run()}
    finally:
        ctx["tmodel"].__dict__.pop("prefill", None)
    logits = {i: rows[p.astype(np.int32).tobytes()]
              for i, p in enumerate(prompts)}
    return done, logits, groups


@pytest.fixture(scope="module")
def ctx():
    cs = _chip_smoke()
    jcfg = dataclasses.replace(smoke_cfg("llama3.2-3b"), dtype=jnp.bfloat16,
                               d_ff=D_FF)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jstore = JStore(JConfig(rho=0.9, bits_high=2, ste_steps=0))
    jstore.register_many({
        f"user_{i}": j_random_lora(jparams["lora"], jax.random.PRNGKey(50 + i),
                                   scale=0.05)
        for i in range(cs.N_ADAPTERS)})
    tstore = AdapterStore()
    for aid in jstore.quantized:
        tstore.register_quantized(aid, quantized_adapter(
            jstore.quantized[aid], "cpu"))
    tmodel = build_model(dataclasses.replace(
        get_config("llama3.2-3b", "smoke"), dtype=torch.bfloat16, d_ff=D_FF))
    return {"cs": cs, "jcfg": jcfg, "jmodel": jmodel, "jparams": jparams,
            "jstore": jstore, "tstore": tstore, "tmodel": tmodel,
            "tparams": to_torch(jparams, "cpu")}


def test_bf16_prefill_grouping_moves_the_reference_logits(ctx):
    """The finding that closes C9 as the reference's semantics: both
    packages prefill the stream in the same groups ((8, 8) all-resident,
    (8, 7, 1) bounded), and the reference's own bf16 prefill logits of a
    request move with the group it is prefilled in (request 14, prefilled
    alone when bounded; XLA's CPU dot sums the 8192-long rows of the down
    projection in an order that depends on the row count). The port on the
    CPU keeps its bits here; on the card cuBLAS picks kernels by row count
    and its logits move too (the card's phases 13 and 26). In both
    packages every move is bf16 rounding, under ``chip_smoke``'s
    ``BF16_GAP_RTOL`` of max |logit|."""
    cs = ctx["cs"]
    ids, prompts = cs.zipf_stream(ctx["jcfg"].vocab)
    seen = {}
    for pkg in ("jax", "torch"):
        out_r, log_r, grp_r = _serve(pkg, ctx, ids, prompts, None)
        out_b, log_b, grp_b = _serve(pkg, ctx, ids, prompts, cs.CONT_SLOTS)
        assert len(grp_b) == cs.ZIPF_BOUNDED["admission_waves"]
        scale = max(float(np.abs(l).max()) for l in log_r.values())
        gaps = {i: float(np.abs(log_r[i] - log_b[i]).max()) for i in log_r}
        assert max(gaps.values()) < cs.BF16_GAP_RTOL * scale, (pkg, gaps)
        seen[pkg] = {
            "groups": (grp_r, grp_b),
            "moved": sorted(i for i, g in gaps.items() if g > 0),
            "parted": sorted(i for i in out_r
                             if not np.array_equal(out_r[i], out_b[i]))}
    assert seen["jax"]["groups"] == seen["torch"]["groups"] == (
        [8, 8], [8, 7, 1])
    assert 14 in seen["jax"]["moved"], seen
