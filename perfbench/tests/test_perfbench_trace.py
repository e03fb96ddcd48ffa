"""The profiler arithmetic on a synthetic trace."""

import pytest

from harness import trace


def test_union_busy_and_clip():
    dev = [("k1", 0, 10), ("k2", 5, 15), ("k3", 20, 30), ("k4", 40, 45)]
    assert trace.union(dev) == [(0, 15), (20, 30), (40, 45)]
    assert trace.busy_ns(dev) == 30
    assert trace.busy_ns(trace.clip(dev, 8, 42)) == 7 + 10 + 2


def test_top_ops_sums_by_name():
    dev = [("a", 0, 10), ("b", 10, 40), ("a", 50, 80)]
    assert trace.top_ops(dev) == [["a", 40e-9], ["b", 30e-9]]


def test_idle_gaps_named_by_the_host_range_around_them():
    dev = [("k", 0, 10), ("k", 30, 40)]
    host = [("bench.step", 0, 100), ("aten::mm", 5, 25),
            ("aten::item", 40, 100), ("bench.stretch", 0, 100)]
    gaps = trace.idle_gaps(dev, host, 0, 100)
    assert gaps == [["bench.step > aten::item", pytest.approx(60e-9)],
                    ["bench.step > aten::mm", pytest.approx(20e-9)]]


def test_frame_needs_exactly_one_stretch():
    with pytest.raises(RuntimeError):
        trace.frame([("x", 0, 1)])
    assert trace.frame([("bench.stretch", 3, 9)]) == (3, 9)
