"""``runner_holdback_ms.live``: how long a chunk's output sits launched
before the runner awaits it, once the next chunk is launched, in
milliseconds: over the chunks of a traced window the median of the start
of chunk k's span ``runner.wait`` less the end of its ``runner.launch``
(live cells).  A program without spans reads nothing."""

import statistics


def read(run):
    if not run.trace or run.kind != "live":
        return None
    from quadrs_tpu_torch.utils import profiling

    spans = getattr(profiling.PROFILER, "spans", None)
    if spans is None:
        return None
    spans = spans()
    launched = {s.key: s.end for s in spans if s.name == "runner.launch"}
    held = [s.start - launched[s.key] for s in spans if s.name == "runner.wait" and s.key in launched]
    if not held:
        return None
    return statistics.median(held) / 1e6
