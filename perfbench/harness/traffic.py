"""The one traffic generator: every mix is a data file that this reads.

A mix (``traffic/<name>.json``) gives:

* ``arrival``: ``{"process": "poisson", "rate_per_s": r}`` (an open loop:
  independent exponential gaps, each request due at its time whether or not
  the engine keeps up) or ``{"process": "backlog", "depth": n}`` (a queue
  kept ``n`` deep, so the rows never starve);
* ``prompt_tokens`` / ``output_tokens``: independent lognormal draws
  (``median``, ``sigma``) rounded and clipped to ``[min, max]``, so the
  tail piles up at ``max`` as a context limit clips it;
* ``fleet``: ``adapters`` distinct adapters quantized under ``recipe``,
  chosen with Zipf(``zipf_alpha``) popularity.

Requests come in pages of ``PAGE``. Page ``j``'s gaps and lengths are one
set of independent draws that every seed shares, and each seed serves them
in an order of its own; the prompts' tokens and the adapters are the
seed's. So every seed offers the same sizes and arrivals, with the
clustering of independent draws, and runs of different seeds differ by the
order alone. Request ``i`` is the same for a seed however many are drawn.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Any, Dict, List

import numpy as np

PAGE = 256
_POOL = 0x5EED7A11            # the seed of the pages' shared draws


@dataclasses.dataclass
class Draw:
    index: int
    offset_s: float          # due time after the start of the ramp
    prompt: np.ndarray       # int32 token ids
    max_new: int
    adapter: int


def lengths(spec: Dict[str, Any], rng: np.random.Generator,
            n: int) -> np.ndarray:
    """``n`` independent lognormal lengths, rounded and clipped."""
    v = rng.lognormal(math.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(v), spec["min"], spec["max"]).astype(np.int64)


class Generator:
    """Draws a mix's requests for one seed, page by page."""

    def __init__(self, mix: Dict[str, Any], vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = seed
        self.rng = np.random.default_rng([seed, 0x7A11])
        fleet = mix["fleet"]
        w = 1.0 / np.arange(1, fleet["adapters"] + 1) ** fleet["zipf_alpha"]
        self.popularity = w / w.sum()
        # which adapter is the most popular is drawn from the seed too
        self.rank_to_adapter = self.rng.permutation(fleet["adapters"])
        self.poisson = mix["arrival"]["process"] == "poisson"
        self.rate = float(mix["arrival"].get("rate_per_s", 0.0))
        self.drawn: List[Draw] = []
        self._t = 0.0

    def _page(self):
        j = len(self.drawn) // PAGE
        pool = np.random.default_rng([_POOL, j])
        plen = lengths(self.mix["prompt_tokens"], pool, PAGE)
        olen = lengths(self.mix["output_tokens"], pool, PAGE)
        gaps = (pool.exponential(1.0 / self.rate, PAGE) if self.poisson
                else np.zeros(PAGE))
        order = np.random.default_rng([self.seed, 0x0D3, j])
        plen, olen, gaps = (order.permutation(x) for x in (plen, olen, gaps))
        rng = self.rng
        ranks = rng.choice(len(self.popularity), size=PAGE,
                           p=self.popularity)
        for k in range(PAGE):
            self._t += float(gaps[k])
            prompt = rng.integers(0, self.vocab, size=int(plen[k]),
                                  dtype=np.int64).astype(np.int32)
            self.drawn.append(Draw(
                index=len(self.drawn), offset_s=self._t, prompt=prompt,
                max_new=int(olen[k]),
                adapter=int(self.rank_to_adapter[ranks[k]])))

    def get(self, i: int) -> Draw:
        while len(self.drawn) <= i:
            self._page()
        return self.drawn[i]

    def warm_lengths(self, key: str, k: int = 16) -> List[int]:
        """``k`` lengths spread over the distribution, the clip included
        (the prompt lengths that warm-up prefills)."""
        spec = self.mix[key]
        z = np.array([NormalDist().inv_cdf((i + 0.5) / k) for i in range(k)])
        v = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
        v = np.clip(np.rint(v), spec["min"], spec["max"]).astype(np.int64)
        return sorted({int(x) for x in v} | {int(spec["max"])})

