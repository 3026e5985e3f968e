"""``executor_host_ms_per_batch``: the host time the program's Executor
takes to launch a batch, in milliseconds: its stages' seconds over their
steps under ``utils.profiling.profiled()`` (every stage the program
accounts but the runners' own).  A stage is the region the span
``executor.launch`` covers; the batch's staging and planning lie outside
it."""

RUNNERS = ("stream_runner", "waterfall_runner")


def read(run):
    stages = [v for k, v in run.stages.items() if k not in RUNNERS]
    steps = sum(v[1] for v in stages)
    if not steps:
        return None
    return 1e3 * sum(v[2] for v in stages) / steps
