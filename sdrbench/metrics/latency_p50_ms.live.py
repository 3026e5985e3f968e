"""``latency_p50_ms.live``: the median of the live latencies (the runner's
hold-back of each output by one chunk sets most of it)."""

from sdrbench.arith import percentile


def read(run):
    if run.kind != "live" or not run.latencies:
        return None
    return 1e3 * percentile(run.latencies, 50)
