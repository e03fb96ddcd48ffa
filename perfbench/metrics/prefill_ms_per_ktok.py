"""prefill_ms_per_ktok: the ``prefill`` events' durations in the window (each
ends at the group's first tokens' host read) per thousand prompt tokens."""


def read(out):
    pre = out.window.prefills_in()
    toks = sum(out.prompt_len[r] for e, _ in pre for r in e["request_ids"])
    if not toks:
        return None
    return sum(e["dur_s"] for e, _ in pre) * 1e3 / (toks / 1e3)
