"""The readers of the program's raw spans (``admit_ms_per_step``,
``decode_host_ms``, ``page_copy_ms``) on a hand-built outcome and span log,
and on a smoke run of the cell on the CPU, where the page copies are timed
on the host."""

import time
import types

import pytest

import smoke
from harness import main as hm
from harness.spec import Cell, reader
from repro_torch.serving import telemetry
from repro_torch.serving.telemetry import SpanLog

NAMES = ("admit_ms_per_step", "decode_host_ms", "page_copy_ms")
MS = 1_000_000                      # ns


def _outcome(t0_ns, t1_ns, decodes):
    win = types.SimpleNamespace(t0=t0_ns / 1e9, t1=t1_ns / 1e9,
                                decodes_in=lambda: [None] * decodes)
    return types.SimpleNamespace(window=win)


def _read(name, out):
    return reader(smoke.BENCH, name)(out)


@pytest.fixture
def log(monkeypatch):
    log = SpanLog(capacity=64)
    monkeypatch.setattr(telemetry, "SPANS", log)
    return log


def _span(log, name, start_ms, end_ms, arg):
    log.add(log.name_id(name), int(start_ms * MS), int(end_ms * MS), arg)


def test_the_readers_on_a_hand_built_log(log):
    # window [100, 200] ms, four decode steps ending in it
    out = _outcome(100 * MS, 200 * MS, decodes=4)
    _span(log, "engine.admit", 80, 95, 1)          # ends before the window
    _span(log, "engine.decode.prep", 95, 99, 1)
    _span(log, "engine.decode.launch", 99, 101, 1)  # its prep is outside
    for k, (a, p, l) in enumerate([(2, 1, 3), (6, 2, 4), (0, 1, 2)]):
        t = 110 + 25 * k
        _span(log, "engine.admit", t, t + a, k + 2)
        _span(log, "engine.decode.prep", t + a, t + a + p, k + 2)
        _span(log, "engine.decode.launch", t + a + p, t + a + p + l, k + 2)
    _span(log, "memory.page_copy", 120, 120.5, 4096)
    _span(log, "memory.page_copy", 130, 131.5, 4096)
    _span(log, "engine.admit", 199, 201, 5)        # ends after it
    assert _read("admit_ms_per_step", out) == pytest.approx(8 / 4)
    # steps 2-4 have both spans in the window: 4, 6 and 3 ms
    assert _read("decode_host_ms", out) == pytest.approx(4.0)
    assert _read("page_copy_ms", out) == pytest.approx(1.0)


def test_nothing_to_read_gives_none(log):
    out = _outcome(100 * MS, 200 * MS, decodes=4)
    assert all(_read(n, out) is None for n in NAMES)
    _span(log, "engine.admit", 110, 112, 1)
    assert _read("admit_ms_per_step", _outcome(100 * MS, 200 * MS, 0)) \
        is None
    assert _read("page_copy_ms", out) is None
    assert _read("decode_host_ms", out) is None


def test_an_overflowed_window_gives_none(log):
    small = SpanLog(capacity=4)
    telemetry.SPANS = small
    for k in range(6):
        _span(small, "engine.admit", 100 + 10 * k, 102 + 10 * k, k)
        _span(small, "memory.page_copy", 103 + 10 * k, 104 + 10 * k, k)
    assert small.overflow == 8
    out = _outcome(100 * MS, 200 * MS, decodes=4)
    assert all(_read(n, out) is None for n in NAMES)
    # a window after the overwritten records is read: one admission of
    # 2 ms over two steps
    late = _outcome(145 * MS, 200 * MS, decodes=2)
    assert _read("admit_ms_per_step", late) == pytest.approx(1.0)


def test_a_program_without_the_span_log_gives_none(monkeypatch):
    monkeypatch.delattr(telemetry, "SPANS")
    out = _outcome(0, int(time.perf_counter() * 1e9), decodes=4)
    assert all(_read(n, out) is None for n in NAMES)


def test_a_smoke_run_on_the_cpu_reads_every_span_metric(tmp_path):
    root = smoke.make_root(tmp_path)
    cell = Cell(root, "mixtral-chat")
    assert set(NAMES) <= {m["name"] for m in cell.per_layer}
    res = hm.execute(cell, 2**31 + 5, 4.0, True, "cpu", time.perf_counter())
    got = res["metrics"]
    assert got["admit_ms_per_step"]["value"] > 0
    assert got["decode_host_ms"]["value"] > 0
    assert got["page_copy_ms"]["value"] > 0
