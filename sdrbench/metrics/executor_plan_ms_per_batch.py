"""``executor_plan_ms_per_batch``: the host time the program's Executor
takes to plan a batch (``stream.plan``: every window's offsets, phases and
valid counts), in milliseconds.  The spans ``executor.plan`` of a traced
window over its batches (its ``executor.launch`` spans; capture cells).  A
program without spans reads nothing."""


def read(run):
    if not run.trace or run.kind != "capture":
        return None
    from quadrs_tpu_torch.utils import profiling

    spans = getattr(profiling.PROFILER, "spans", None)
    if spans is None:
        return None
    spans = spans()
    batches = sum(1 for s in spans if s.name == "executor.launch")
    mine = [s.end - s.start for s in spans if s.name == "executor.plan"]
    if not batches or not mine:
        return None
    return sum(mine) / batches / 1e6
