"""itl_p95_ms: 95th percentile of the gaps between consecutive output tokens,
over every gap that ends in the window, across all requests."""

from harness.stats import percentile


def read(out):
    v = percentile(out.window.token_gaps(), 95)
    return None if v is None else v * 1e3
