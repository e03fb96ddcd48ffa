"""adapter_hit_rate: the paged adapter memory's hits over its lookups in the
window (its own counters, read at the window's start and close), in %."""


def read(out):
    n = out.memory["lookups"]
    return 100.0 * out.memory["hits"] / n if n else None
