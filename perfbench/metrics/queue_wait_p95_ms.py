"""queue_wait_p95_ms: 95th percentile of submit-to-admission waits of the
requests admitted in the window (raw ``admit`` events)."""

from harness.stats import percentile


def read(out):
    v = percentile(out.window.queue_waits(), 95)
    return None if v is None else v * 1e3
