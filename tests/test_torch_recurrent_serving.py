"""Port vs reference: rwkv6-1.6b and recurrentgemma-2b served
(``repro_torch.serving`` / ``launch.serve`` against ``repro``) at the
smoke sizes of ``test_torch_recurrent_models.py`` (``RecModels``), fp32 on
the CPU.

Adapters are quantized by JAX, so both packages serve the same codes, and
the reference runs its kernels in interpret mode. Held exactly: greedy
tokens step by step, the paging sequence, the pools, and the port's
``sgmv_fused`` calls against the reference's launches. Pad tokens flow
through the recurrent states in both engines, so a left-padded row's
tokens depend on its padded length; and both refuse an rwkv6 prompt whose
padded length the chunk does not divide (ROADMAP C10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LoRAQuantConfig as JConfig
from repro.serving.engine import AdapterStore as JStore
from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS, PLAIN_CALLS,
                                               reset_launch_counts)
from repro_torch.serving import MultiLoRAEngine
from test_torch_continuous import _count_reference, _lockstep
from test_torch_memory import (assert_pools_equal, bridge_store, requests,
                               trace_paging)
from test_torch_recurrent_models import PER_FORWARD, RG, RG2, RWKV, models_of


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)



def _mixed_requests(vocab, seq, lens, seed, max_new):
    """``requests`` with the prompt lengths ``lens``."""
    jreqs, treqs = requests(vocab, seq, seed=seed, max_new=max_new,
                            plen=max(lens))
    for jr, tr, n in zip(jreqs, treqs, lens):
        jr.prompt, tr.prompt = jr.prompt[:n].copy(), tr.prompt[:n].copy()
    return jreqs, treqs


@pytest.mark.parametrize("name", [RWKV, RG2])
def test_continuous_packed_serve_matches_reference(name):
    """Five requests of three adapters through three rows, all resident,
    their prompts 13, 16, 11, 9 and 16 tokens: the first prefill group
    mixes padded lengths (13, 16, 11 pad to 16), so pad tokens flow
    through its rows' states, and the port gives the reference's tokens
    step by step; ``PLAIN_CALLS`` equal its launches (one per LoRA linear
    per forward), served from packed codes only. Request 2 served alone,
    still padded to 16, gives its grouped tokens: a row's tokens depend
    on its padded length, not on the rows beside it."""
    m = models_of(name)
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({f"u{i}": m.trained(7 + i) for i in range(3)})
    tstore = bridge_store(jstore)
    jeng, teng = m.engines(jstore, tstore, capacity=48, max_rows=3)
    jcounts = _count_reference(m, jeng, 48)
    seq, lens = ["u0", "u1", "u2", "u0", "u1"], [13, 16, 11, 9, 16]
    jreqs, treqs = _mixed_requests(m.jcfg.vocab, seq, lens, 3, 4)
    reset_launch_counts()
    _, tdone = _lockstep(jeng, teng, jreqs, treqs)
    forwards = teng._step_count + teng._wave
    assert tstore.fp_resident_bytes() == 0
    assert dict(PLAIN_CALLS) == jcounts == {
        "sgmv_fused": PER_FORWARD[name] * forwards}
    assert not LAUNCH_COUNTS
    solo = MultiLoRAEngine(m.tmodel, m.tparams, tstore, cache_capacity=48,
                           max_rows=1)
    alone = _mixed_requests(m.jcfg.vocab, seq, lens, 3, 4)[1]
    solo.submit(alone[2])                  # 11 tokens: tpad 16, 5 pads
    (req,) = solo.run()
    grouped = next(r for r in tdone if r.request_id == 2)
    np.testing.assert_array_equal(req.output, grouped.output)
    assert teng._wave >= 2


@pytest.mark.parametrize("name", [RWKV, RG2])
def test_bounded_continuous_paging_matches_reference(name):
    """A Zipf-like stream over 5 adapters through 2 rows and 2 device
    slots, 16-token prompts: the reference's tokens, every ``acquire`` /
    ``prefetch`` of its paging, its stats, its pools bit for bit (both of
    recurrentgemma's groups, whose LoRA sets differ) and its launches;
    bounded tokens == all-resident == materialize (no pads)."""
    m = models_of(name)
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({f"u{i}": m.trained(20 + i) for i in range(5)})
    tstore = bridge_store(jstore)
    jeng, teng = m.engines(jstore, tstore, capacity=32, max_rows=2,
                           hbm_slots=2)
    jlog, tlog = trace_paging(jeng.memory), trace_paging(teng.memory)
    jcounts = _count_reference(m, jeng, 32)
    seq = ["u0", "u1", "u0", "u2", "u3", "u0", "u4", "u1"]
    jreqs, treqs = requests(m.jcfg.vocab, seq, seed=11, max_new=3, plen=16)
    reset_launch_counts()
    _, tdone = _lockstep(jeng, teng, jreqs, treqs)
    assert dict(PLAIN_CALLS) == jcounts == {"sgmv_fused": PER_FORWARD[name]
                                            * (teng._step_count + teng._wave)}
    assert tlog == jlog and any(e[0] == "acquire" for e in tlog)
    st = teng.memory_stats()
    assert st == jeng.memory_stats() and st["evictions"] > 0
    assert_pools_equal(jeng.memory, teng.memory)
    for mode, slots in (("continuous", None), ("materialize", None)):
        eng = MultiLoRAEngine(m.tmodel, m.tparams, tstore, cache_capacity=32,
                              max_rows=2, mode=mode, hbm_slots=slots)
        for r in requests(m.jcfg.vocab, seq, seed=11, max_new=3,
                          plen=16)[1]:
            eng.submit(r)
        ref = {r.request_id: r.output for r in eng.run()}
        for r in tdone:
            np.testing.assert_array_equal(r.output, ref[r.request_id])
    if name == RG2:
        pool = next(iter(teng.memory._pools.values()))
        assert pool.arrays["/groups/1/sub_1/mixer/w_out"][
            "ah_codes"].shape[:2] == (1, 2)


@pytest.mark.parametrize("arch", [RWKV, RG])
def test_serve_driver_recurrent_smoke(arch, capsys):
    """``serve.py --arch`` at the smoke preset, one row at a time: bounded
    to 1 slot it gives the all-resident run's tokens, one ``sgmv_fused``
    per LoRA linear per forward."""
    from repro_torch.launch import serve

    common = ["--arch", arch, "--preset", "smoke", "--device", "cpu",
              "--adapters", "3", "--requests", "4", "--prompt-len", "8",
              "--max-new", "3", "--max-rows", "1"]
    reset_launch_counts()
    bounded = serve.main(common + ["--slots", "1"])
    assert dict(PLAIN_CALLS) == {"sgmv_fused": 4 * 3 * PER_FORWARD[arch]}
    out = capsys.readouterr().out
    assert "1 slots in 1 pool(s)" in out and "evictions 0" not in out
    resident = serve.main(common)
    assert len(bounded) == len(resident) == 4
    got = {r.request_id: r.output.tolist() for r in bounded}
    for r in resident:
        assert len(r.output) == 3 and got[r.request_id] == r.output.tolist()


def test_rwkv_prompt_past_one_chunk_raises_in_both_packages():
    """ROADMAP C10: the engine pads a 65-token prompt to 72 tokens and
    RWKV's chunked scan takes chunks of ``min(64, T)``; 72 is no multiple
    of 64, so both engines raise the reference's ``ValueError`` at the
    prefill, as do both ``Model.prefill`` calls on the 65 tokens (the
    port matches the reference; it does not fix it)."""
    from repro.serving.engine import MultiLoRAEngine as JEngine
    from repro.serving.engine import Request as JRequest
    from repro_torch.serving import Request

    m = models_of(RWKV)
    jstore = JStore(JConfig(rho=0.9, ste_steps=0))
    jstore.register_many({"u0": m.trained(5)})
    tstore = bridge_store(jstore)
    prompt = np.random.default_rng(6).integers(0, 512, 65).astype(np.int32)
    jeng = JEngine(m.jmodel, m.jparams, jstore, cache_capacity=96)
    teng = MultiLoRAEngine(m.tmodel, m.tparams, tstore, cache_capacity=96)
    jeng.submit(JRequest(request_id=0, adapter_id="u0", prompt=prompt,
                         max_new_tokens=2))
    teng.submit(Request(request_id=0, adapter_id="u0", prompt=prompt,
                        max_new_tokens=2))
    assert teng._tpad(teng.pending[0]) == 72
    msg = "seq len 72 must be divisible by chunk 64"
    with pytest.raises(ValueError, match=msg):
        jeng.step()
    with pytest.raises(ValueError, match=msg):
        teng.step()
    msg = "seq len 65 must be divisible by chunk 64"
    with pytest.raises(ValueError, match=msg):
        m.jmodel.prefill(m.jparams, {"tokens": jnp.asarray(prompt[None])},
                         96)
    with pytest.raises(ValueError, match=msg):
        m.tmodel.prefill(m.tparams, {"tokens": torch.from_numpy(
            prompt[None]).long()}, 96)
    out, _ = m.tmodel.prefill(m.tparams, {"tokens": torch.from_numpy(
        prompt[None, :64]).long()}, 96)
    assert out.shape == (1, 64, 512)
