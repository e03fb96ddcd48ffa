"""Faults planted under the timed path, each of which the check has to
fail: a token altered where it is produced, a decode step that leaves its
state (the KV cache) unchanged, and rows served by another slot's adapter
(seg ids shifted). Each wraps ``Model.decode_step``; ``planted`` puts one
in place for the length of a ``with`` block. A card has no exchange
between chips to leave out, and serving has no batch mean to take over
half the rows."""

from __future__ import annotations

import contextlib

from .program import Model


def alter_a_token(orig):
    calls = {"n": 0}

    def decode_step(self, params, tokens, caches, pos, start=None):
        logits, caches = orig(self, params, tokens, caches, pos, start)
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            logits = logits.clone()
            logits[:, -1, 1] = logits.max() + 1.0
        return logits, caches
    return decode_step


def state_unchanged(orig):
    def decode_step(self, params, tokens, caches, pos, start=None):
        scratch = [{k: {n: t.clone() for n, t in v.items()}
                    for k, v in g.items()} for g in caches]
        logits, _ = orig(self, params, tokens, scratch, pos, start)
        return logits, caches
    return decode_step


def wrong_adapter(orig):
    def decode_step(self, params, tokens, caches, pos, start=None):
        lora = dict(params["lora"])
        lora["seg"] = (lora["seg"] + 1) % 3
        return orig(self, {**params, "lora": lora}, tokens, caches, pos,
                    start)
    return decode_step


FAULTS = {"token_altered": alter_a_token, "state_unchanged": state_unchanged,
          "wrong_adapter": wrong_adapter}


@contextlib.contextmanager
def planted(name: str):
    orig = Model.decode_step
    Model.decode_step = FAULTS[name](orig)
    try:
        yield
    finally:
        Model.decode_step = orig
