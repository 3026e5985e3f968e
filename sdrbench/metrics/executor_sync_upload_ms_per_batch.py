"""``executor_sync_upload_ms_per_batch``: the part of
``executor_host_ms_per_batch`` the program's Executor spends putting a
batch's plan on the card, in milliseconds: each plan tensor a synchronous
copy from pageable memory, which waits for the work queued before it.  The
spans ``executor.sync_upload`` of a traced window over its batches (its
``executor.launch`` spans; capture cells).  A program without spans reads
nothing."""


def read(run):
    if not run.trace or run.kind != "capture":
        return None
    from quadrs_tpu_torch.utils import profiling

    spans = getattr(profiling.PROFILER, "spans", None)
    if spans is None:
        return None
    spans = spans()
    batches = sum(1 for s in spans if s.name == "executor.launch")
    mine = [s.end - s.start for s in spans if s.name == "executor.sync_upload"]
    if not batches or not mine:
        return None
    return sum(mine) / batches / 1e6
