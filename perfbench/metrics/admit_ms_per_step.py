"""admit_ms_per_step: the ``engine.admit`` spans ending in the window (each
step's whole admission loop: selection with its acquires and swap-ins, each
group's prefill to its first tokens' host read, the cache-row copies),
summed, over the window's decode steps (``engine_step_ms``'s count), in ms."""

from metrics import _spans


def read(out):
    spans = _spans.in_window(out, "engine.admit")
    n = len(out.window.decodes_in())
    if spans is None or not n:
        return None
    return sum(s.end - s.start for s in spans) / 1e6 / n
