"""decode_host_ms: the median over the window's decode steps of the host's
time to dispatch the decode, ``engine.decode.prep`` (input rows, serving
tree and its decode view, upload, next wave's prefetch) plus
``engine.decode.launch`` (enqueueing the whole forward), in ms; a step
counts when both of its spans end in the window."""

from harness.stats import percentile
from metrics import _spans


def read(out):
    spans = _spans.in_window(out, "engine.decode.prep",
                             "engine.decode.launch")
    if spans is None:
        return None
    steps = {}
    for s in spans:
        steps.setdefault(s.arg, []).append(s.end - s.start)
    host = [sum(d) for d in steps.values() if len(d) == 2]
    v = percentile(host, 50)
    return None if v is None else v / 1e6
