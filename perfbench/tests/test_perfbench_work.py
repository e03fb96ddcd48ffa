"""The yardstick's FLOPs and bytes, checked by hand on a smoke config."""

import types

import numpy as np
import pytest

import smoke
from harness.record import Forward
from metrics import _work
from harness.spec import reader


def test_dense_token_flops_by_hand():
    cfg = smoke.smoke_config("internlm2-20b")
    d, f, v, r, L = 128, 128, 512, 16, 2
    attn = 2 * (d * 128 + d * 64 + d * 64 + 128 * d)
    ffn = 2 * 3 * d * f
    lora = 2 * r * ((d + 128) + 2 * (d + 64) + (128 + d) + 3 * (d + f))
    assert _work.per_token(cfg) == L * (attn + ffn + lora) + 2 * d * v
    assert _work.attention(cfg, 10) == 4 * 4 * 32 * 10 * L
    assert _work.prompt_flops(cfg, 3) == 3 * _work.per_token(cfg) + \
        _work.attention(cfg, 6)


def test_moe_token_counts_top_k_experts_and_the_router():
    cfg = smoke.smoke_config("mixtral-8x22b-l8")
    d, f, e, r = 128, 128, 4, 16
    attn = 2 * (d * 128 + 2 * d * 64 + 128 * d) + 2 * r * (
        (d + 128) + 2 * (d + 64) + (128 + d))
    router = 2 * d * e + 2 * r * (d + e)
    experts = 2 * (2 * 3 * d * f + 2 * r * (2 * (d + f) + (f + d)))
    assert _work.per_token(cfg) == 2 * (attn + router + experts) + 2 * d * 512


def test_entry_bytes_by_the_paper_accounting():
    # out 256, in 128, rank 16 split at h = 4, 2-bit codes
    hi = 4 * (256 + 128) * 2 / 8 + 4 * (2 + 1) * (2 + 0.25)
    lo = 12 * ((256 + 128) / 8 + 3 * 2)
    assert _work.entry_bytes(256, 128, 16, 4, 2) == pytest.approx(hi + lo)
    # a router of 4 outputs: the rank is capped at 4
    assert _work.entry_bytes(4, 128, 16, 4, 2) == pytest.approx(
        4 * 132 * 2 / 8 + 4 * 2 * 2.25)


def test_lora_call_bound_is_the_larger_term():
    t = _work.lora_call(1, 6144, 6144, 16, 1e6)
    assert t == pytest.approx((1e6 + 2 * 12288) / _work.PEAK_BYTES)
    big = _work.lora_call(1e6, 6144, 6144, 16, 0)
    assert big == pytest.approx(max(1e6 * 12288 * 2 / _work.PEAK_BYTES,
                                    2e6 * 16 * 12288 / _work.PEAK_FLOPS))


def test_lora_roofline_counts_active_rows_and_served_entries():
    cfg = smoke.smoke_config("mixtral-8x22b-l8")
    mix = smoke.smoke_mix("chat-paged")
    k, e, L = 2, 4, 2
    # one decode of 3 rows: rows 0 and 2 active (adapters 0, 1), row 1 idle
    routing = []
    for _ in range(L):
        ex = np.array([0, 1, 2, 3, 0, 2])          # (row, slot) flattened
        kept = np.array([True, True, True, True, True, False])
        routing.append((ex, 8, kept))
    fwd = Forward("decode", [(0, 10, 4), (2, 11, 7)], routing=routing)
    h = {name: [3] * (L * (e if name.startswith("x") else 1))
         for name in _work.shapes(cfg)}
    out = types.SimpleNamespace(
        cfg=cfg, mix=mix, stretch=[fwd], adapter_of={10: 0, 11: 1},
        prompt_len={}, entry_h={0: h, 1: h},
        trace={"by_name": {"sgmv_fused_kernel<1>": (1.0, 9),
                           "other": (5.0, 1)}})
    want = 0.0
    shapes = _work.shapes(cfg)
    for _ in range(L):
        for name in ("wq", "wk", "wv", "wo", "router"):
            i, o = shapes[name]
            byt = 2 * _work.entry_bytes(o, i, 16, 3, 2)
            want += _work.lora_call(2, i, o, min(16, i, o), byt)
        for name in ("xwg", "xwu", "xwd"):
            i, o = shapes[name]
            # kept real assignments: (a0, e0), (a0, e1), (a1, e0)
            byt = 3 * _work.entry_bytes(o, i, 16, 3, 2)
            want += _work.lora_call(3, i, o, 16, byt)
    got = reader(smoke.BENCH, "lora_roofline")(out)
    assert got == pytest.approx(100.0 * want / 1.0)
