"""Port vs reference: deepseek-v3-671b's model, its MTP training loss and
its continuous multi-LoRA serve
(``repro_torch.models`` / ``serving`` against ``repro``) at the smoke size
(1 dense + 2 MoE layers, d_model 128, MLA ranks 32 / 16, 4 int8 experts
top-2 of width 64, one shared expert), fp32 on the CPU.

Parameters are initialized by JAX and carried across by the bridge;
adapters are quantized by JAX, so both packages serve the same codes, and
the reference runs its Pallas kernels in interpret mode. Held: outputs,
logits and losses within ``RTOL`` x max |y| (fp32 sums in other orders),
LoRA gradients within ``GRAD_RTOL`` of each leaf's max |grad|, greedy
tokens, the paging sequence and the pools exactly, and the port's
``sgmv_fused`` calls against the reference's launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LoRAQuantConfig as JConfig
from repro.serving.engine import AdapterStore as JStore
from repro_torch.bridge import to_torch
from repro_torch.kernels.quant_matmul import PLAIN_CALLS, reset_launch_counts
from repro_torch.optim import adamw as topt
from repro_torch.serving import MultiLoRAEngine
from test_torch_continuous import _count_reference, _lockstep
from test_torch_faults import ROOT, load
from test_torch_memory import (assert_pools_equal, bridge_store, requests,
                               trace_paging)
from test_torch_mla import DSModels, trained as _trained
from test_torch_train_step import _nonzero_b, close_leaves

ARCH = "deepseek-v3-671b"
# LoRA linears per layer: MLA's wq_down, wq_up, wkv_down, wo, then the
# dense FFN's wg wu wd, or the router and the shared expert's wg wu wd
DENSE_LINEARS, MOE_LINEARS = 7, 8
PER_FORWARD = DENSE_LINEARS + 2 * MOE_LINEARS
# fp32 outputs of a 3-layer model or one MoE layer, relative to max |y|
RTOL = 2e-5
# fp32 LoRA gradients, relative to each leaf's max |grad|
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


@pytest.fixture(scope="module")
def models():
    return DSModels()


@pytest.fixture(scope="module")
def dropfree():
    return DSModels(cf=2.0)


def test_lora_linears_per_layer(models):
    """The reference's LoRA tree has 7 linears in a dense layer and 8 in
    an MoE layer (no per-expert adapters): the counts every launch check
    here and on the card uses; the port's own template has the same paths
    and shapes."""
    from repro.serving.engine import iter_lora_linears as j_iter
    from repro_torch.serving.engine import iter_lora_linears as t_iter

    jpaths = {p: tuple(leaf["a"].shape)
              for p, leaf in j_iter(models.jparams["lora"])}
    for gi, n in ((0, DENSE_LINEARS), (1, MOE_LINEARS)):
        assert sum(p.startswith(f"/groups/{gi}/") for p in jpaths) == n
    assert sorted(p.rsplit("/", 1)[-1] for p in jpaths
                  if "/groups/1/" in p) == sorted(
        ["wq_down", "wq_up", "wkv_down", "wo", "router", "wg", "wu", "wd"])
    tparams = models.tmodel.init(seed=0, device="cpu")
    assert {p: tuple(leaf["a"].shape)
            for p, leaf in t_iter(tparams["lora"])} == jpaths


# --------------------------------------------------------------------------
# the model: prefill / decode and the MTP training loss
# --------------------------------------------------------------------------

def test_prefill_and_decode_match_reference(models):
    """Left-padded prefill and three decode steps (absorbed MLA, per-row
    ``valid_start``) with a trained fp adapter: logits, greedy tokens and
    the latent caches."""
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
    for gi in (0, 1):
        assert set(tc[gi]["sub_0"]) == {"c", "kr"}
        for name in ("c", "kr"):
            _close(tc[gi]["sub_0"][name], jc[gi]["sub_0"][name])


def test_train_loss_with_mtp_and_lora_grads_match_reference(dropfree):
    """``train_loss`` with the multi-token-prediction head (loss = CE + aux
    + 0.3 x the MTP CE), drop-free: loss, CE and aux, and the gradient of
    every LoRA leaf against ``jax.grad``; the MTP head moves the loss."""
    models = dropfree
    params = {"base": models.jparams["base"],
              "lora": _nonzero_b(models.jparams["lora"],
                                 jax.random.PRNGKey(1))}
    g = np.random.default_rng(4)
    toks = g.integers(0, models.jcfg.vocab, (3, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][:, 2] = -1

    def f(lora):
        return models.jmodel.train_loss(
            {"base": params["base"], "lora": lora},
            {k: jnp.asarray(v) for k, v in batch.items()})

    (jloss, jm), jgrad = jax.value_and_grad(f, has_aux=True)(params["lora"])
    tparams = to_torch(params, "cpu")
    leaves = topt.tree_leaves(tparams["lora"])
    for leaf in leaves:
        leaf.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, metrics = models.tmodel.train_loss(tparams, tbatch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]),
                               rtol=RTOL)
    np.testing.assert_allclose(metrics["aux"].item(), float(jm["aux"]),
                               rtol=RTOL)
    assert float(jm["aux"]) > 0
    mtp = (loss - metrics["ce"] - metrics["aux"]).item() / 0.3
    assert 0.5 * np.log(models.jcfg.vocab) < mtp < 2 * np.log(
        models.jcfg.vocab)
    close_leaves([gr.numpy() for gr in grads], jgrad, GRAD_RTOL,
                 "deepseek d/dlora")
    assert all(float(np.abs(gr.numpy()).max()) > 0 for gr in grads)


# --------------------------------------------------------------------------
# serving: the continuous engine over packed codes and paged memory
# --------------------------------------------------------------------------

def test_continuous_packed_serve_matches_reference(dropfree):
    """Three requests of two adapters through two rows, drop-free: the
    reference's tokens step by step, ``PLAIN_CALLS`` equal to its launches
    (1 dense + 2 MoE layers: 23 per forward), served from packed codes
    only, and the port's own materialize engine's tokens."""
    models = dropfree
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({f"u{i}": _trained(models, 7 + i) for i in range(2)})
    tstore = bridge_store(jstore)
    jeng, teng = models.engines(jstore, tstore, capacity=32, max_rows=2)
    jcounts = _count_reference(models, jeng, 32)
    seq = ["u0", "u1", "u0"]
    jreqs, treqs = requests(models.jcfg.vocab, seq, seed=3, max_new=3,
                            plen=8)
    reset_launch_counts()
    _, tdone = _lockstep(jeng, teng, jreqs, treqs)
    forwards = teng._step_count + teng._wave
    assert tstore.fp_resident_bytes() == 0        # served from packed codes
    assert dict(PLAIN_CALLS) == jcounts == {
        "sgmv_fused": PER_FORWARD * forwards}
    mat = MultiLoRAEngine(models.tmodel, models.tparams, tstore,
                          cache_capacity=32, mode="materialize")
    for r in requests(models.jcfg.vocab, seq, seed=3, max_new=3, plen=8)[1]:
        mat.submit(r)
    ref = {r.request_id: r.output for r in mat.run()}
    assert tstore.fp_resident_bytes() > 0
    for r in tdone:
        np.testing.assert_array_equal(r.output, ref[r.request_id])


def test_bounded_continuous_paging_matches_reference(models):
    """A Zipf-like stream over 5 adapters through 2 rows and 2 device
    slots with the config's own capacity factor (drops included): the
    reference's tokens, every ``acquire`` / ``prefetch`` of its paging,
    its stats and its pools (both layer groups' leaves, whose LoRA sets
    differ) bit for bit."""
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({f"u{i}": _trained(models, 20 + i)
                          for i in range(5)})
    tstore = bridge_store(jstore)
    jeng, teng = models.engines(jstore, tstore, capacity=32, max_rows=2,
                                hbm_slots=2)
    jlog, tlog = trace_paging(jeng.memory), trace_paging(teng.memory)
    seq = ["u0", "u1", "u0", "u2", "u3", "u0", "u4", "u1"]
    jreqs, treqs = requests(models.jcfg.vocab, seq, seed=11, max_new=3,
                            plen=8)
    _lockstep(jeng, teng, jreqs, treqs)
    assert tlog == jlog and any(e[0] == "acquire" for e in tlog)
    st = teng.memory_stats()
    assert st == jeng.memory_stats() and st["evictions"] > 0
    assert_pools_equal(jeng.memory, teng.memory)
    pool = next(iter(teng.memory._pools.values()))
    dense = pool.arrays["/groups/0/sub_0/ffn/wg"]["ah_codes"]
    shared = pool.arrays["/groups/1/sub_0/ffn/shared/wg"]["ah_codes"]
    assert dense.shape[:2] == (1, 2) and shared.shape[:2] == (2, 2)
    assert "/groups/1/sub_0/ffn/router" in pool.arrays


def test_serve_driver_deepseek_smoke(capsys):
    """``serve.py --arch deepseek-v3-671b`` at the smoke preset, one row at
    a time: bounded to 1 slot it gives the all-resident run's tokens, one
    ``sgmv_fused`` per LoRA linear per forward."""
    from repro_torch.launch import serve

    common = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu",
              "--adapters", "3", "--requests", "4", "--prompt-len", "6",
              "--max-new", "3", "--max-rows", "1"]
    reset_launch_counts()
    bounded = serve.main(common + ["--slots", "1"])
    # 4 requests x (1 prefill + 2 decode steps)
    assert dict(PLAIN_CALLS) == {"sgmv_fused": 4 * 3 * PER_FORWARD}
    out = capsys.readouterr().out
    assert "1 slots in 1 pool(s)" in out and "evictions 0" not in out
    resident = serve.main(common)
    assert len(bounded) == len(resident) == 4
    got = {r.request_id: r.output.tolist() for r in bounded}
    for r in resident:
        assert len(r.output) == 3 and got[r.request_id] == r.output.tolist()


def test_chip_smoke_deepseek_phases_rehearse_on_the_cpu():
    """``chip_smoke.py``'s phases 31-35 on the CPU at the smoke size (the
    plain versions in place of the kernels; phase 31 by its shapes): the
    nine (K, M) of the full config and its 37 launches per forward at 3 +
    2 layers, MLA's decode against its sequence forward and blockwise
    against plain, the continuous serve with the reference's paging, the
    drop-free routing / token / logit parity, and the MTP loss's
    backward."""
    chip_smoke = load("chip_smoke", ROOT / "chip_smoke.py")
    full = chip_smoke.ds_config(torch.bfloat16)
    dense, moe = chip_smoke.ds_linears(full)
    assert sorted(set(dense.values()) | set(moe.values())) == sorted([
        (7168, 1536), (1536, 24576), (7168, 512), (16384, 7168),
        (7168, 256), (7168, 2048), (2048, 7168), (7168, 18432),
        (18432, 7168)])
    assert chip_smoke.ds_per_forward(chip_smoke.ds_config(
        torch.bfloat16, chip_smoke.DS_LAYERS["cuda"])) == 3 * 7 + 2 * 8
    mla = chip_smoke.phase_mla("cpu", "smoke")
    assert mla["decode_err"] <= mla["tol"]
    assert mla["attn_err"] <= mla["attn_tol"]
    cont = chip_smoke.phase_ds_serve("cpu", "smoke")
    assert cont["launches"] == PER_FORWARD * 24       # 3 groups + 21 steps
    parity = chip_smoke.phase_ds_parity("cpu", "smoke")
    assert parity["gap"] <= parity["tol"]
    train = chip_smoke.phase_ds_train("cpu", "smoke")
    assert np.isfinite(train["loss"]) and train["grad_norm"] > 0
