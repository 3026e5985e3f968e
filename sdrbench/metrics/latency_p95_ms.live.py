"""``latency_p95_ms.live``: the 95th percentile, over every chunk of the
window, of the time from the due time of the last sample a chunk reads to
its output reaching the sink (live cells).  A per-layer metric: on a host
whose CPU supply swings from run to run it spreads too widely to be bound
end to end."""

from sdrbench.arith import percentile


def read(run):
    if run.kind != "live" or not run.latencies:
        return None
    return 1e3 * percentile(run.latencies, 95)
