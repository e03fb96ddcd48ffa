"""``decode_graph_share`` on hand-built span logs: the share of the window's
decode launches that enclose a replay, and None for a program that has no
replay span (one without decode graphs)."""

import types

import pytest

import smoke
from harness.spec import reader
from repro_torch.serving import telemetry
from repro_torch.serving.telemetry import SpanLog

MS = 1_000_000                      # ns


def _outcome(t0_ms, t1_ms):
    return types.SimpleNamespace(window=types.SimpleNamespace(
        t0=t0_ms * MS / 1e9, t1=t1_ms * MS / 1e9))


def _read(out):
    return reader(smoke.BENCH, "decode_graph_share")(out)


@pytest.fixture
def log(monkeypatch):
    log = SpanLog(capacity=64)
    monkeypatch.setattr(telemetry, "SPANS", log)
    return log


def _span(log, name, start_ms, end_ms, arg):
    log.add(log.name_id(name), int(start_ms * MS), int(end_ms * MS), arg)


def test_the_share_of_launches_that_replay(log):
    # window [100, 200] ms; steps 2-5 launch in it, 2, 3 and 5 replay
    _span(log, "engine.decode.launch", 90, 95, 1)      # ends before it
    # (the log holds spans in the order they end)
    for k in range(2, 6):
        t = 100 + 20 * (k - 2)
        if k != 4:
            _span(log, "engine.decode.replay", t + 1, t + 4, k)
        _span(log, "engine.decode.launch", t, t + 5, k)
        if k == 4:
            # a replay outside its step's launch does not count
            _span(log, "engine.decode.replay", 146, 147, 4)
    _span(log, "engine.decode.replay", 182, 183, 4)
    assert _read(_outcome(100, 200)) == pytest.approx(75.0)
    assert _read(_outcome(141, 190)) == pytest.approx(50.0)
    assert _read(_outcome(141, 150)) == 0.0
    # replays but no launch in the window
    assert _read(_outcome(166, 200)) is None
    # a window of eager steps only
    assert _read(_outcome(141, 146)) == 0.0


def test_a_program_without_replay_spans_gives_none(log):
    for k in range(3):
        _span(log, "engine.decode.launch", 110 + 10 * k, 115 + 10 * k, k)
    assert "engine.decode.replay" not in log.names
    assert _read(_outcome(100, 200)) is None
    log.name_id("engine.decode.replay")
    assert _read(_outcome(100, 200)) == 0.0
    assert _read(_outcome(300, 400)) is None      # no launch in the window
