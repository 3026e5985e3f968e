"""``msps``: capture samples the command completed over the wall time of
all the window's passes, in millions a second (capture cells)."""


def read(run):
    if run.kind != "capture" or not run.samples:
        return None
    return run.samples / run.window_s / 1e6
