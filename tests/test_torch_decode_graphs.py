"""The continuous decode forward replayed from CUDA graphs
(``repro_torch.models.graphs``), broken at each MoE layer's dispatch.

On the CPU: the per-device constants that replace the forward's host copies
equal what they replace; the engine captures nothing off the card or under
a mesh; the segment plan run without graphs (each island run where a
capture breaks the forward) equals ``decode_step`` bit for bit on the smoke
mixtral, and the inputs' key stays put through swap-ins and is computed
only when the engine's arguments are new; kernel symbols map to their
wrappers. On the card
(marked ``cuda``, skipped here): in continuous serves of the smoke mixtral
and llama with admissions, swap-ins and retirements, the replayed decode
gives the eager tokens and logits bit for bit and the eager launches per
forward; each forward calls the dispatch once per MoE layer, and what it
returned keeps its values through later replays; a swap-in keeps the graphs
and a pool resize recaptures them; the captured graphs' kernel nodes are
the launches recorded, and a capture whose nodes differ or whose pool would
crowd the eager work out is refused and served eagerly. This file imports no JAX, so it runs on
the card as well:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_decode_graphs.py -q
"""

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import LoRAQuantConfig
from repro_torch.kernels.quant_matmul import LAUNCH_COUNTS, reset_launch_counts
from repro_torch.launch.serve import random_trained_lora
from repro_torch.models import attention, build_model, common, ffn, graphs
from repro_torch.models.graphs import DecodeGraphs, inputs_key
from repro_torch.serving import (AdapterStore, MultiLoRAEngine, Request,
                                 Telemetry)
from repro_torch.serving import engine as eng_mod
from repro_torch.serving.telemetry import SPANS

CPU = torch.device("cpu")
RECIPE_A = LoRAQuantConfig(rho=0.9, ste_steps=4)
RECIPE_B = LoRAQuantConfig(rho=0.9, bits_high=3, ste_steps=4)


def _fleet(arch, dtype, device, n=4, recipes=None):
    """A smoke model of ``arch`` and ``n`` adapters ``u0..`` (``recipes``:
    id -> recipe; the store's default otherwise)."""
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=dtype)
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    store = AdapterStore(RECIPE_A)
    gen = torch.Generator(device=device).manual_seed(3)
    store.register_many({f"u{i}": random_trained_lora(params["lora"], gen,
                                                      scale=0.05)
                         for i in range(n)}, recipes=recipes)
    return cfg, model, params, store


def _moe_layers(cfg) -> int:
    return sum(b.count for b in cfg.blocks for f in b.ffn if f == "moe")


def _request(cfg, rid, adapter, plen, max_new):
    g = np.random.default_rng(100 + rid)
    return Request(request_id=rid, adapter_id=adapter,
                   prompt=g.integers(0, cfg.vocab, size=plen).astype(np.int32),
                   max_new_tokens=max_new, keep_logits=True)


def _submit_stream(eng, cfg, n=10):
    """``n`` requests over the four adapters, mixed lengths and budgets,
    more than the rows hold: admissions mid-decode and retirements."""
    for rid in range(n):
        eng.submit(_request(cfg, rid, f"u{(rid * 3) % 4}", 3 + (5 * rid) % 11,
                            2 + (3 * rid) % 7))


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


# ------------------------------------------------------------------ the CPU


def test_cached_rope_tables_and_neg_inf_equal_what_they_replace():
    for dh, theta in ((32, 10000.0), (64, 1e6), (16, 500000.0)):
        want = torch.as_tensor(common.rope_freqs(dh, theta),
                               dtype=torch.float32, device=CPU)
        got = common._rope_table(dh, theta, CPU)
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert common._rope_table(dh, theta, CPU) is got
    sections = (4, 6, 6)
    assert torch.equal(common._section_ids(sections, CPU), torch.as_tensor(
        np.repeat(np.arange(len(sections)), sections)))
    neg = attention._neg_inf(CPU)
    assert neg.dim() == 0 and neg.dtype == torch.float32
    assert torch.equal(neg, torch.tensor(attention.NEG_INF,
                                         dtype=torch.float32))
    assert attention._neg_inf(CPU) is neg

    # the rotations as they were computed before the tables were cached
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 4, 32, generator=g)
    pos = torch.arange(5)[None].expand(2, 5) + 3
    freqs = torch.as_tensor(common.rope_freqs(32, 10000.0),
                            dtype=torch.float32)
    ang = (pos.to(torch.float32)[..., None] * freqs)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    old = torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                     x2 * torch.cos(ang) + x1 * torch.sin(ang)], dim=-1)
    assert torch.equal(common.apply_rope(x, pos, 10000.0), old)
    grid = torch.stack([pos, pos + 1, pos * 2])
    ids = torch.as_tensor(np.repeat(np.arange(3), sections))
    ang = torch.movedim(grid.to(torch.float32)[ids], 0, -1) * freqs
    ang = ang[..., None, :]
    old = torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                     x2 * torch.cos(ang) + x1 * torch.sin(ang)], dim=-1)
    assert torch.equal(common.apply_mrope(x, grid, sections, 10000.0), old)
    with pytest.raises(ValueError, match="must sum to"):
        common.apply_mrope(x, grid, (4, 6, 5), 10000.0)


@pytest.fixture(scope="module")
def moe_cpu():
    return _fleet("mixtral-8x22b", torch.float32, "cpu")


def test_the_engine_captures_nothing_on_the_cpu_or_under_a_mesh(moe_cpu):
    cfg, model, params, store = moe_cpu
    assert DecodeGraphs.supported(model, "cuda")
    assert not DecodeGraphs.supported(model, "cpu")
    meshed = dataclasses.replace(model, mesh=types.SimpleNamespace(
        shape={"data": 1, "model": 1}))
    assert not DecodeGraphs.supported(meshed, "cuda")
    tel = Telemetry()
    eng = MultiLoRAEngine(model, params, store, cache_capacity=48,
                          max_rows=3, hbm_slots=2, telemetry=tel)
    assert eng._graphs is None
    _submit_stream(eng, cfg, n=5)
    t0 = time.perf_counter()
    done = eng.run()
    names = {s.name for s in SPANS.between(t0, time.perf_counter())}
    assert len(done) == 5 and eng._step_count > 2
    assert "engine.decode.launch" in names
    assert not names & {"engine.decode.capture", "engine.decode.replay"}
    assert model._armed is None
    assert "decode_graph" not in tel.to_prometheus()


def test_the_segment_plan_run_uncaptured_equals_decode_step(moe_cpu,
                                                            monkeypatch):
    cfg, model, params, store = moe_cpu
    layers = _moe_layers(cfg)
    assert layers == 2
    calls = []
    orig = ffn._dispatch_indices

    def counting(ids, n_experts, capacity):
        calls.append(ids.shape[0])
        return orig(ids, n_experts, capacity)

    monkeypatch.setattr(ffn, "_dispatch_indices", counting)
    islands = []

    def island(ids, n_experts, capacity):
        # where a capture ends a segment, a replay runs the island
        isl = graphs._Island.at(ids, n_experts, capacity)
        isl.run()
        islands.append(isl)
        return isl.plan

    checked = []

    def decode_step(params, tokens, caches, pos, start=None):
        with torch.no_grad():
            want = model._decode(params, tokens, _clone(caches), pos, start)
            n0 = len(calls)
            islands.clear()
            monkeypatch.setattr(ffn, "_ISLAND", island)
            got = model._decode(params, tokens, _clone(caches), pos, start)
            monkeypatch.setattr(ffn, "_ISLAND", None)
        assert len(islands) == len(calls) - n0 == layers
        assert torch.equal(got, want)
        checked.append(inputs_key((params, tokens, caches, pos, start)))
        return type(model).decode_step(model, params, tokens, caches, pos,
                                       start)

    model.decode_step = decode_step
    try:
        eng = MultiLoRAEngine(model, params, store, cache_capacity=48,
                              max_rows=3, hbm_slots=2)
        _submit_stream(eng, cfg, n=6)
        eng.run()
    finally:
        del model.decode_step
    assert len(checked) == eng._step_count > 3 and eng.memory.swap_ins > 2
    # the rows, caches and pool tensors are the engine's own every step: a
    # fixed pool's swap-ins do not move the inputs' key
    assert len(set(checked)) == 1
    assert ffn._ISLAND is None


def test_kernel_symbols_map_to_their_wrappers():
    names = [
        "_ZN12_GLOBAL__N_117sgmv_fused_kernelILi1E13__nv_bfloat16EEvN9lora"
        "quant7cluster6ParamsE",
        "_ZN12_GLOBAL__N_115sgmv_out_kernelILi2EfEEvN9loraquant7cluster6"
        "ParamsE",
        "_ZN12_GLOBAL__N_117matmul_out_kernelILi1EfEEvN9loraquant7cluster6"
        "ParamsE",
        "_ZN12_GLOBAL__N_117fused_lora_kernelILi4EfEEvN9loraquant7cluster6"
        "ParamsE",
        "_ZN12_GLOBAL__N_117sgmv_fused_kernelILi8E13__nv_bfloat16EEvN9lora"
        "quant7cluster6ParamsE",
        "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctor"
        "IfEENS_6detail5ArrayIPcLi1EEEEEviT0_T1_",
        "nvjet_tst_512x24_64x3_2x1_v_bz_NNT",
    ]
    assert graphs.wrapper_nodes(names) == {"sgmv_fused": 2, "sgmv_out": 1,
                                           "matmul_out": 1, "fused_lora": 1}


def test_the_inputs_key_is_computed_when_the_arguments_are_new(
        moe_cpu, monkeypatch):
    cfg, model, params, store = moe_cpu
    keys, captures = [], []
    orig = graphs.inputs_key

    def key(args):
        keys.append(args)
        return orig(args)

    def capture(self, step, args):
        captures.append(step)
        return False                    # the CPU cannot capture

    monkeypatch.setattr(graphs, "inputs_key", key)
    monkeypatch.setattr(DecodeGraphs, "_capture", capture)
    eng = MultiLoRAEngine(model, params, store, cache_capacity=48,
                          max_rows=3, hbm_slots=2)
    eng._graphs = DecodeGraphs(model)
    views = []
    retile = eng_mod.retile_packed

    def counting_retile(*a):
        views.append(1)
        return retile(*a)

    monkeypatch.setattr(eng_mod, "retile_packed", counting_retile)
    _submit_stream(eng, cfg, n=6)
    eng.run()
    # one key per new tuple of arguments, a new tuple per new decode view
    assert eng._step_count > len(keys) == len(views) > 1
    assert len({id(a) for a in keys}) == len(keys)
    # inputs seen at two steps in a row are captured once, and the failed
    # key is not tried again
    assert len(captures) == 1 and eng._graphs.failures == 0
    assert model._armed is None


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _serve(fleet, graphs=True, slots=2, telemetry=None, per_call=None):
    """The stream through a continuous engine (decode graphs on or off):
    ``({rid: (tokens, logits)}, engine)``; ``per_call`` collects each
    decode call's launches."""
    cfg, model, params, store = fleet
    eng = MultiLoRAEngine(model, params, store, cache_capacity=64,
                          max_rows=4, hbm_slots=slots, telemetry=telemetry)
    if not graphs:
        eng._graphs = None
    _submit_stream(eng, cfg)
    if per_call is not None:
        def decode_step(*args):
            before = dict(LAUNCH_COUNTS)
            out = type(model).decode_step(model, *args)
            per_call.append({k: v - before.get(k, 0)
                             for k, v in LAUNCH_COUNTS.items()
                             if v != before.get(k, 0)})
            return out
        model.decode_step = decode_step
    reset_launch_counts()
    try:
        done = eng.run()
    finally:
        if per_call is not None:
            del model.decode_step
    torch.cuda.synchronize()
    return {r.request_id: (r.output.tolist(), r.logits) for r in done}, eng


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama3.2-3b"])
def test_replayed_decode_equals_eager_bitwise_cuda(cuda, arch):
    fleet = _fleet(arch, torch.bfloat16, cuda)
    tel = Telemetry()
    got_calls, want_calls = [], []
    got, eng = _serve(fleet, telemetry=tel, per_call=got_calls)
    tel.uninstall_kernel_counter()
    launches = sum(LAUNCH_COUNTS.values())
    want, eng0 = _serve(fleet, graphs=False, per_call=want_calls)
    runner = eng._graphs
    assert eng0._graphs is None and runner.failures == 0
    # the first step's inputs are served eagerly, captured at the second
    assert runner.captures == 1
    assert runner.replays == eng._step_count - 1 > 4
    # two slots, four adapters: each swapped in, the graphs kept through it
    assert eng.memory.swap_ins >= 4
    assert got.keys() == want.keys()
    for rid in want:
        assert got[rid][0] == want[rid][0], rid
        assert np.array_equal(got[rid][1], want[rid][1]), rid
    assert got_calls == want_calls and len(got_calls) == eng._step_count
    # what each replay counts is what the graphs hold
    assert graphs.wrapper_nodes(n for g in runner._graphs
                                for n in graphs.kernel_names(g)) == \
        runner._launches and sum(runner._launches.values()) > 0
    reg = tel.registry
    assert reg.value("pallas_launches_total") == launches
    assert reg.value("decode_graph_captures_total") == 1
    assert reg.value("decode_graph_replays_total") == runner.replays


@pytest.mark.cuda
def test_each_forward_dispatches_once_per_moe_layer_and_keeps_it_cuda(
        cuda, monkeypatch):
    fleet = _fleet("mixtral-8x22b", torch.bfloat16, cuda)
    cfg, model = fleet[0], fleet[1]
    orig = ffn._dispatch_indices
    kept = []

    def dispatch(ids, n_experts, capacity):
        out = orig(ids, n_experts, capacity)
        live = (ids, out[0], out[1], out[2], out[3])
        kept.append((live, tuple(t.clone() for t in live)))
        return out

    monkeypatch.setattr(ffn, "_dispatch_indices", dispatch)
    per_call = []
    dec = type(model).decode_step

    def decode_step(*args):
        n0 = len(kept)
        out = dec(model, *args)
        per_call.append(len(kept) - n0)
        return out

    model.decode_step = decode_step
    try:
        _, eng = _serve(fleet)
    finally:
        del model.decode_step
    assert eng._graphs.replays == eng._step_count - 1 > 4
    assert per_call == [_moe_layers(cfg)] * eng._step_count
    for live, snap in kept:
        for a, b in zip(live, snap):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_swap_in_keeps_the_graphs_and_a_resize_recaptures_cuda(cuda):
    recipes = {"u0": RECIPE_A, "u1": RECIPE_A, "u2": RECIPE_B,
               "u3": RECIPE_B}
    fleet = _fleet("mixtral-8x22b", torch.bfloat16, cuda, recipes=recipes)
    cfg, model, params, store = fleet
    eng = MultiLoRAEngine(model, params, store, cache_capacity=64,
                          max_rows=4)                 # all-resident
    runner = eng._graphs
    eng.submit(_request(cfg, 0, "u0", 5, 12))
    eng.submit(_request(cfg, 1, "u2", 7, 12))
    for _ in range(4):
        eng.step()
    assert runner.captures == 1 and runner.replays == 3
    # two pools, so the tree carries lookups: first swap-ins of the other
    # adapters rebuild it, and the graphs stay
    swaps = eng.memory.swap_ins
    eng.submit(_request(cfg, 2, "u1", 4, 6))
    eng.submit(_request(cfg, 3, "u3", 9, 6))
    eng.run()
    assert eng.memory.swap_ins == swaps + 2 and runner.captures == 1
    # a new adapter outgrows its pool while both of its slots are pinned:
    # the pool is reallocated, the next step runs eagerly and the one after
    # is captured anew
    eng.submit(_request(cfg, 5, "u0", 5, 10))
    eng.submit(_request(cfg, 6, "u1", 6, 10))
    eng.step()
    eng.step()
    assert runner.captures == 1 and eng.active_rows == 2
    gen = torch.Generator(device=cuda).manual_seed(9)
    store.register("u4", random_trained_lora(params["lora"], gen,
                                             scale=0.05), recipe=RECIPE_A)
    eng.submit(_request(cfg, 4, "u4", 6, 8))
    eng.run()
    assert runner.captures == 2 and runner.failures == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["nodes", "room"])
def test_a_capture_that_does_not_check_out_is_served_eagerly_cuda(
        cuda, fault, monkeypatch):
    fleet = _fleet("mixtral-8x22b", torch.bfloat16, cuda)
    want, _ = _serve(fleet, graphs=False)
    if fault == "nodes":
        # a graph that lost one of the wrappers' kernels
        names = graphs.kernel_names

        def lost_one(g):
            out = names(g)
            out.remove(next(n for n in out if "sgmv_fused_kernel" in n))
            return out

        monkeypatch.setattr(graphs, "kernel_names", lost_one)
    else:
        # a card whose room outside the pools is below the pool's size
        pool_bytes = graphs.graph_pool_bytes

        def crowded(pool, dev):
            size = pool_bytes(pool, dev)[0]
            return size, size - 1

        monkeypatch.setattr(graphs, "graph_pool_bytes", crowded)
    tel = Telemetry()
    got, eng = _serve(fleet, telemetry=tel)
    tel.uninstall_kernel_counter()
    runner = eng._graphs
    assert runner.captures == runner.replays == 0
    assert runner.failures == 1 and runner._graphs == []
    assert tel.registry.value("decode_graph_capture_failures_total") == 1
    assert got.keys() == want.keys()
    for rid in want:
        assert got[rid][0] == want[rid][0], rid
        assert np.array_equal(got[rid][1], want[rid][1]), rid
