"""``peak_device_gib``: ``torch.cuda.max_memory_allocated()`` over the
window (its peak reset as the window opens), in GiB."""


def read(run):
    if run.device.type != "cuda" or not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2**30
