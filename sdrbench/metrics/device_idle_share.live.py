"""``device_idle_share.live``: as ``device_idle_share.capture``, in the
live cells."""


def read(run):
    if run.device.type != "cuda":
        return None  # a device number comes from the card alone
    if run.kind != "live" or "busy_s" not in run.trace_out or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace_out["busy_s"] / run.window_s)
