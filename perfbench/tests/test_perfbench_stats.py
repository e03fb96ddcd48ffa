"""Percentiles over raw samples, rates over the whole window."""

import types

import pytest

from harness.stats import Window, percentile


def _fwd(kind, rows):
    return types.SimpleNamespace(kind=kind, rows=rows, tpad=8)


def _window():
    events = [
        {"event": "admit", "ts": 0.9, "request_id": 1, "queue_wait_s": 0.2},
        {"event": "prefill", "ts": 1.0, "request_ids": [1], "dur_s": 0.1,
         "tpad": 8},
        {"event": "first_token", "ts": 1.0, "request_id": 1},
        {"event": "decode_step", "ts": 1.5, "active_rows": 1},
        {"event": "admit", "ts": 1.6, "request_id": 2, "queue_wait_s": 0.5},
        {"event": "prefill", "ts": 1.7, "request_ids": [2], "dur_s": 0.2,
         "tpad": 8},
        {"event": "first_token", "ts": 1.7, "request_id": 2},
        {"event": "decode_step", "ts": 2.0, "active_rows": 2},
        {"event": "decode_step", "ts": 3.0, "active_rows": 1},
    ]
    fwds = [_fwd("prefill", [(1, None)]), _fwd("decode", [(0, 1, 5)]),
            _fwd("prefill", [(2, None)]),
            _fwd("decode", [(0, 1, 6), (1, 2, 3)]),
            _fwd("decode", [(1, 2, 4)])]
    return Window(events, fwds, 0.5, 3.0, {1: 5, 2: 3})


def test_percentile_of_raw_samples():
    assert percentile([], 95) is None
    assert percentile([5.0], 95) == 5.0
    assert percentile(range(101), 95) == pytest.approx(95.0)


def test_tokens_over_the_whole_window():
    w = _window()
    assert w.tokens() == {"prompt": 8, "generated": 2 + 4}
    assert w.seconds == 2.5


def test_ttft_counts_a_request_still_waiting_at_the_close():
    w = _window()
    due = {1: 0.6, 2: 1.2, 3: 2.0, 4: 3.5}
    assert sorted(w.ttfts(due)) == pytest.approx([0.4, 0.5, 1.0])


def test_token_gaps_start_at_the_first_token():
    w = _window()
    assert sorted(w.token_gaps()) == pytest.approx([0.3, 0.5, 0.5, 1.0])


def test_queue_waits_of_admissions_in_the_window():
    assert sorted(_window().queue_waits()) == [0.2, 0.5]


def test_the_window_refuses_unmatched_forwards():
    events = [{"event": "decode_step", "ts": 1.0, "active_rows": 1}]
    with pytest.raises(RuntimeError):
        Window(events, [], 0.0, 2.0, {})
