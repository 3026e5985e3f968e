"""``chunk_host_ms_p95.live``: the program's own host time on a chunk, in
milliseconds: over the chunks of a traced window the 95th percentile of
the sum of chunk k's spans ``staging.fill``, ``runner.upload``,
``runner.launch``, ``runner.wait`` and ``runner.recycle``; without the
waits for input (``staging.read``), for a slot (``staging.slot``) or for
the queue (``staging.handoff``, ``runner.next``), and without the sink's
``runner.emit`` (live cells).  A program without spans reads nothing."""

from collections import defaultdict

from sdrbench.arith import percentile

OWN = ("staging.fill", "runner.upload", "runner.launch", "runner.wait", "runner.recycle")


def read(run):
    if not run.trace or run.kind != "live":
        return None
    from quadrs_tpu_torch.utils import profiling

    spans = getattr(profiling.PROFILER, "spans", None)
    if spans is None:
        return None
    spans = spans()
    chunks = {s.key for s in spans if s.name == "runner.launch"}
    own: dict = defaultdict(int)
    for s in spans:
        if s.name in OWN and s.key in chunks:
            own[s.key] += s.end - s.start
    if not own:
        return None
    return percentile(list(own.values()), 95) / 1e6
