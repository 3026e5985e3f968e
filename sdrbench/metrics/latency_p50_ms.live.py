"""``latency_p50_ms.live``: the median of the live latencies, each from a
chunk's due time to its output reaching the sink (live cells): the read's
lag behind the source's blocks and the program's own work on the chunk."""

from sdrbench.arith import percentile


def read(run):
    if run.kind != "live" or not run.latencies:
        return None
    return 1e3 * percentile(run.latencies, 50)
