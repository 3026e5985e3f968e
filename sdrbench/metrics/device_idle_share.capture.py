"""``device_idle_share.capture``: the share of the window in which no
kernel, copy or set ran on the card: 100 less the union of the profiler's
device intervals over the window's wall, in percent (capture cells)."""


def read(run):
    if run.device.type != "cuda":
        return None  # a device number comes from the card alone
    if run.kind != "capture" or "busy_s" not in run.trace_out or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace_out["busy_s"] / run.window_s)
