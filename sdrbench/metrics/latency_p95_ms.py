"""``latency_p95_ms``: the 95th percentile, over every chunk of the
window, of the time from the due time of the last sample a chunk reads to
its output reaching the sink (live cells)."""

from sdrbench.arith import percentile


def read(run):
    if run.kind != "live" or not run.latencies:
        return None
    return 1e3 * percentile(run.latencies, 95)
