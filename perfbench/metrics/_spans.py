"""The program's raw spans that end in a run's window.

The port logs them in ``repro_torch.serving.telemetry.SPANS`` (a bounded
ring on ``time.perf_counter_ns``, the clock of the window's ends). A program
without that log, or whose ring overwrote part of the window, gives None,
and so does a window in which none of the named spans ends."""


def in_window(out, *names):
    """The spans named ``names`` that end in the window, or None."""
    try:
        from repro_torch.serving import telemetry
    except ImportError:
        return None
    log = getattr(telemetry, "SPANS", None)
    if log is None:
        return None
    spans = log.between(out.window.t0, out.window.t1)
    if spans is None:
        return None
    return [s for s in spans if s.name in names] or None
