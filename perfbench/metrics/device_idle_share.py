"""device_idle_share: the share of the profiled stretch's wall time in which
no kernel, copy or memset ran on the card, in %."""


def read(out):
    if out.trace is None or out.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - out.trace["busy_s"] / out.trace["window_s"])
