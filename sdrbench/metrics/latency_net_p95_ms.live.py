"""``latency_net_p95_ms.live``: the live latency that the program itself
controls: over every chunk of the window, the 95th percentile of the time
from the later of its due time and the start of the generator's write of
the block that holds the last sample it reads, to its output reaching the
sink (live cells).  A generator that was late moves ``latency_p95_ms.live``
and not this; a write that blocked on a pipe the program had left full moves
both."""

from sdrbench.arith import percentile


def read(run):
    if run.kind != "live" or not run.net_latencies:
        return None
    return 1e3 * percentile(run.net_latencies, 95)
