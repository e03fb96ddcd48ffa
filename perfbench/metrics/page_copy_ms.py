"""page_copy_ms: the mean time of a swap-in's page copies
(``memory.page_copy``) resolved in the window, in ms. On the card it is the
stream's time between a pair of CUDA events around the copies: the copies
themselves and the gaps in which the stream waited for the host to enqueue
the next one. On the CPU, whose copies are synchronous, it is the host's."""

from metrics import _spans


def read(out):
    spans = _spans.in_window(out, "memory.page_copy")
    if spans is None:
        return None
    return sum(s.end - s.start for s in spans) / len(spans) / 1e6
