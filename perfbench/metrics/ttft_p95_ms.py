"""ttft_p95_ms: 95th percentile of due-to-first-token over every request due
in the window; one still waiting at the close counts its wait so far."""

from harness.stats import percentile


def read(out):
    v = percentile(out.window.ttfts(out.due), 95)
    return None if v is None else v * 1e3
