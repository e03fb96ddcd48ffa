"""The one generator: repeatable per seed, different across seeds, every
seed serving each page's independent draws in an order of its own."""

import json

import numpy as np
import pytest

import smoke
from harness import traffic


def _mix(name):
    return json.loads((smoke.BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat-paged", "summarize-backlog"])
def test_one_seed_repeats_and_seeds_differ(name):
    mix = _mix(name)
    a = traffic.Generator(mix, 32768, 2**31 + 11)
    b = traffic.Generator(mix, 32768, 2**31 + 11)
    c = traffic.Generator(mix, 32768, 2**31 + 12)
    for i in (0, 5, 47, 300):
        da, db = a.get(i), b.get(i)
        assert (da.offset_s, da.max_new, da.adapter) == (db.offset_s,
                                                         db.max_new,
                                                         db.adapter)
        assert np.array_equal(da.prompt, db.prompt)
    assert any(not np.array_equal(a.get(i).prompt, c.get(i).prompt)
               for i in range(16))
    assert [len(a.get(i).prompt) for i in range(16)] != [
        len(c.get(i).prompt) for i in range(16)]


@pytest.mark.parametrize("name", ["chat-paged", "summarize-backlog"])
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
def test_every_seed_serves_the_same_draws_in_its_own_order(name, seed):
    mix = _mix(name)
    ref = traffic.Generator(mix, 100, 7)
    g = traffic.Generator(mix, 100, seed)
    n = traffic.PAGE
    for page in range(2):
        span = range(page * n, (page + 1) * n)

        def sizes(gen):
            return (sorted(len(gen.get(i).prompt) for i in span),
                    sorted(gen.get(i).max_new for i in span))
        assert sizes(g) == sizes(ref)
    assert g.get(2 * n - 1).offset_s == pytest.approx(
        ref.get(2 * n - 1).offset_s)


def test_poisson_gaps_are_independent_draws_at_the_rate():
    mix = _mix("chat-paged")
    g = traffic.Generator(mix, 100, 9)
    n = 40 * traffic.PAGE
    t = np.array([g.get(i).offset_s for i in range(n)])
    gaps = np.diff(np.concatenate([[0.0], t]))
    rate = mix["arrival"]["rate_per_s"]
    # over 10240 draws each share below has a standard deviation of about
    # 0.005 (0.003 for the clusters); the bounds are four of them
    assert t[-1] * rate == pytest.approx(n, rel=0.04)
    # exponential: as many gaps above the mean as e^-1 of them, and
    # clusters: gaps a tenth of the mean or less, about 1 - e^-0.1
    assert np.mean(gaps > 1 / rate) == pytest.approx(np.exp(-1), abs=0.02)
    assert np.mean(gaps < 0.1 / rate) == pytest.approx(1 - np.exp(-0.1),
                                                      abs=0.012)


@pytest.mark.parametrize("name", ["chat-paged", "summarize-backlog"])
def test_lengths_are_clipped_so_the_tail_piles_at_the_limit(name):
    mix = _mix(name)
    g = traffic.Generator(mix, 100, 3)
    n = 4 * traffic.PAGE
    for key, vals in (("prompt_tokens", [len(g.get(i).prompt)
                                         for i in range(n)]),
                      ("output_tokens", [g.get(i).max_new
                                         for i in range(n)])):
        spec = mix[key]
        vals = np.array(vals)
        assert vals.min() >= spec["min"] and vals.max() <= spec["max"]
        tail = np.mean(np.log(vals) >= np.log(spec["max"]))
        above = 1 - traffic.NormalDist().cdf(
            np.log(spec["max"] / spec["median"]) / spec["sigma"])
        assert tail == pytest.approx(above, abs=0.025), key
        assert spec["max"] in g.warm_lengths(key)


def test_zipf_popularity_prefers_the_head():
    mix = _mix("chat-paged")
    g = traffic.Generator(mix, 100, 4)
    counts = np.bincount([g.get(i).adapter for i in range(2000)],
                         minlength=64)
    top = g.rank_to_adapter[0]
    assert counts[top] == counts.max()
    assert counts.sum() == 2000
